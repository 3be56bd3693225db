"""Multi-device and multi-process execution: data-parallel and row-sharded
(tensor-parallel) search over a mesh of devices (sharded.py), and the same
across processes on torch.distributed (multihost.py)."""
