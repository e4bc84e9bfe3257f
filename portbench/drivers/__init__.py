"""The general generators, one file each: ``drivers/<driver>.py`` defines
``Driver``, found by the ``driver`` that a traffic file names.  A traffic
mix is data that one of them reads; a new driver is a new file here.

A ``Driver(config, traffic, seed, device, control=False)`` builds the
cell's inputs from the seed, drives the port's real entry, and holds what
the window produced to the plain reference:

  host_ranges   (module, attribute, label) of the port's calls that the
                traced run names in its host ranges
  setup()       inputs, the program's state, warm-up of every shape
  window(s)     the measured work, for at least ``s`` seconds
  work()        what the window finished, e.g. {"iterations": n}; the
                end-to-end metrics' readers divide by it
  attempted()   requests (iterations, sweeps) the window started
  release()     after the window: the program's outputs copied out, its
                state freed
  check()       {number: reading} compared against the cell's limits
  failed(lim)   how many of the window's checked answers are past them
  close()       frees what is left

With ``control=True`` the plain reference computed with TF32 allowed
takes the program's place (the lower precision that the limits are set
against); the tests and ``calibrate.py`` use it, the benchmark never.
"""
from __future__ import annotations

import torch


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def record(name: str):
    """A host range the traced run keeps (``profile.RANGE_PREFIX``)."""
    return torch.profiler.record_function("portbench/" + name)
