"""The harness: cells found by name, inputs from the seed, the drivers,
the trace's reading and the comparison."""
