"""The LM zoo's models (port of ``repro/models``): the dense GQA decoder."""
