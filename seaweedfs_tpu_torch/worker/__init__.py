"""Maintenance worker fleet: the control plane the master hosts
(`worker.control.WorkerControl`) and the worker that executes its tasks
(`worker.worker.Worker`).

Port of seaweedfs_tpu/worker/. Unlike the JAX package this
`__init__` imports neither module: the master imports `control` alone,
and `worker` imports the EC package (torch), which a master alone must
not load (a torch import on the card's host takes seconds).
"""
