"""Whether the frames of the window are right: each frame the seed kept is
held, at pixels the seed draws, against the plain reference
(render_bench/reference.py), which renders them again from the scene and
the frame's viewpoint.

A pixel is far when, for every colour the reference admits there (the
ties it keeps), some channel differs from the program's by more than
FAR_LSB. The number compared is the share of far pixels among all those
drawn; its limit is the configuration's ``far_share_max``.
"""

from __future__ import annotations

import torch

from render_bench import reference, scene, traffic

# Frames of the window the check reads (a reservoir drawn from the seed).
FRAMES = 4
# Pixels read in each of them, drawn from the seed.
PIXELS = 16384
# A channel further than this from every admitted colour makes a pixel far.
FAR_LSB = 8


def pixels(cfg: dict, seed: int, k: int):
    """The (N, 2) (x, y) pixels the check reads in the window's frame k."""
    w, h = cfg["resolution"]
    idx = traffic.rng(seed, 2 + k).choice(w * h, size=min(PIXELS, w * h), replace=False)
    return torch.as_tensor(idx % w), torch.as_tensor(idx // w)


def errors(cand, mask, got):
    """Per pixel, the least over the admissible reference colours of the
    largest channel difference from ``got`` (N, 3) u8."""
    d = (cand.int() - got[:, None].int()).abs().amax(dim=2)
    return torch.where(mask, d, 256).amin(dim=1)


def frame_errors(ref_scene, spec, img, xs, ys):
    dev = ref_scene.device
    got = img[ys.to(img.device), xs.to(img.device)].to(dev)
    cand, mask = reference.render_pixels(ref_scene, spec, torch.stack([xs, ys], 1).to(dev))
    return errors(cand, mask, got)


def check(kept, cfg: dict, seed: int, device) -> dict:
    """The numbers compared, each with its limit. ``kept``: (window frame
    index, u8 image, spec) of the frames the seed kept."""
    ref_scene = scene.reference_scene(cfg, device)
    far = total = 0
    for k, img, spec in kept:
        xs, ys = pixels(cfg, seed, k)
        err = frame_errors(ref_scene, spec, img, xs, ys)
        far += int((err > FAR_LSB).sum())
        total += len(err)
    return {
        "checked_frames": {"value": len(kept), "min": 1},
        "far_px_share": {"value": far / max(total, 1), "max": cfg["far_share_max"]},
    }


def holds(number: dict) -> bool:
    v = number["value"]
    return v <= number.get("max", v) and v >= number.get("min", v)
