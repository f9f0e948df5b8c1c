"""Deterministic fault injection for durability testing.

Port of seaweedfs_tpu/faults. See registry.py for the model: named fault
points in production code, seeded triggers + actions armed by tests, a
single-bool no-op fast path when nothing is injected. The port's
registry is its own; arming a point here never arms the JAX package's.
"""

from .registry import (
    REGISTRY,
    FaultHandle,
    FaultRegistry,
    InjectedCrash,
    InjectedFault,
    InjectedIOError,
    active,
    always,
    armed_points,
    bit_flip,
    clear,
    crash,
    every,
    fire,
    hard_exit,
    inject,
    injected,
    io_error,
    latency,
    mutate,
    nth_call,
    probability,
    truncate,
    zero_fill,
)

__all__ = [
    "REGISTRY",
    "FaultHandle",
    "FaultRegistry",
    "InjectedCrash",
    "InjectedFault",
    "InjectedIOError",
    "active",
    "always",
    "armed_points",
    "bit_flip",
    "clear",
    "crash",
    "every",
    "fire",
    "hard_exit",
    "inject",
    "injected",
    "io_error",
    "latency",
    "mutate",
    "nth_call",
    "probability",
    "truncate",
    "zero_fill",
]
