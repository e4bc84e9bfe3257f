"""The distributed layer of the port: the process grid on
``torch.distributed`` and its placements (``sharding``: the RESCAL 2D
grid and the LM's specs), the dense MU engine on it (``engine``), and
the LM's tensor-parallel collectives (``tp``).  Importing it starts no
process group."""
