"""The control-plane mechanisms of the paper (router, radix indexer,
saturation detector, PoA tracker, planner, controller), copied from
``src/repro/core`` with only their import paths changed."""
