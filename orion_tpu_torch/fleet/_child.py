"""Child-process entry point of :class:`orion_tpu_torch.fleet.ProcessReplica`.

A module of its own (not ``replica`` itself), so ``python -m
orion_tpu_torch.fleet._child`` doesn't re-execute a module the package
``__init__`` already imported (runpy's double-import warning)."""

import sys

if __name__ == "__main__":
    from orion_tpu_torch.fleet.replica import _child_main

    sys.exit(_child_main())
