"""arctic_tpu_torch — the PyTorch + CUDA port of arctic_tpu.

The JAX package ``arctic_tpu`` stays the reference; this package renders the
same default fused frame with PyTorch on one NVIDIA Hopper GPU (sm_90a), with
hand-written CUDA kernels where the JAX package wrote Pallas kernels.

Layout mirrors the JAX package:
    core/     render config, maths, scene/settings dataclasses of tensors
    io/       glTF / GLB / OBJ / HDR / PNG load, GLB export, procedural
              scenes; host scene build (numpy) -> tensors on a device
    ops/      raster, binning, cull, shadow, sampling, sky, PBR, tonemap;
              the kernel wrappers live beside their plain torch versions
    models/   the frame pipeline; the f64 golden oracle
    utils/    the CUDA kernel loader, the JAX-package parameter bridge,
              errors, frame stats and traces, state files
    app/      the render CLI (python -m arctic_tpu_torch.app.cli render)
              and the fly camera
    csrc/     CUDA C++ sources of the kernels

Nothing here imports JAX or any module of ``arctic_tpu``: a machine with the
card but without JAX runs the whole package. ``utils/convert.py`` reads the
JAX package's objects only through the leaves its caller hands over.
"""

__version__ = "0.1.0"
