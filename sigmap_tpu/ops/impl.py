"""The one place that picks each device layer's implementation.

Each kernel layer of the turbo round has a plain ``jax.numpy``/``lax``
version that XLA compiles for any backend, and a hand-written Pallas
kernel lowered through Triton that beat it end to end on the GPU.  The GPU
runs the kernel; every other backend runs the plain version.

Interpret mode exists only for tests, which ask for it by name
(``"triton_interpret"``); asking for it on an accelerator is an error, and
a kernel that fails to compile on the GPU fails the run: nothing falls
back to the plain version quietly.
"""

from __future__ import annotations

import jax

PLAIN = "plain"
TRITON = "triton"
TRITON_INTERPRET = "triton_interpret"

# Layers with a Triton kernel that the GPU runs (each beat its plain
# version end to end on an H100; PERF.md holds the times).  Every other
# device layer (events, compression, seeding) is plain jax.numpy/lax.
LAYERS = ("sweep", "chain")


def choose(layer: str, requested: str | None = None) -> str:
    """Implementation name for `layer` on the current default backend.

    requested: None picks the backend's default; tests may name
    "plain", "triton" or "triton_interpret" explicitly."""
    if layer not in LAYERS:
        raise ValueError(f"unknown layer {layer!r}")
    backend = jax.default_backend()
    if requested is None:
        return TRITON if backend == "gpu" else PLAIN
    if requested == TRITON_INTERPRET and backend != "cpu":
        raise ValueError(
            f"interpret mode for {layer!r} requested on the {backend} "
            "backend; it exists only for CPU tests"
        )
    if requested == TRITON and backend != "gpu":
        raise ValueError(
            f"the {layer!r} Triton kernel needs the gpu backend "
            f"(have {backend})"
        )
    if requested not in (PLAIN, TRITON, TRITON_INTERPRET):
        raise ValueError(f"unknown implementation {requested!r}")
    return requested
