"""The distributed RESCAL engine of the port: the 2D process grid on
``torch.distributed`` (``sharding``) and the dense MU engine on it
(``engine``).  Importing it starts no process group."""
