"""The control and the faults of the check, planted under the timed path.

Each plant wraps an entry module (entries/<name>.py) and goes in through
``cell.entry`` (``planted``), so that a run with it goes through the same
set-up, window and check as a sound run, and ``correct`` has to come out
false:

- ``control``: the reference computed in bfloat16 with no ties, in the
  program's place at every pixel the check reads;
- ``stale``: every frame hands back the first frame's image (a step that
  returns its state unchanged);
- ``half``: the lower half of every image left black;
- ``altered``: every image 24 LSB redder, as made;
- ``no_light_shadows``: the program set up without the point lights'
  shadow rays that the mix asks for.
"""

from __future__ import annotations

from contextlib import contextmanager


def control(mod):
    class Control:
        MODE = mod.MODE

        @staticmethod
        def setup(run):
            import torch

            from render_bench import check, reference, scene
            from render_bench.run import WARM_FRAMES

            frame = mod.setup(run)
            ref = scene.reference_scene(run.cfg, run.device)
            calls = [0]

            def ctl(spec):
                img, stats = frame(spec)
                k = calls[0] - WARM_FRAMES  # the frame's index in the window
                calls[0] += 1
                if k < 0:
                    return img, stats
                xs, ys = check.pixels(run.cfg, run.seed, k)
                pix = torch.stack([xs, ys], 1).to(run.device)
                col, mask = reference.render_pixels(ref, spec, pix, torch.bfloat16, exact=False)
                img = img.clone()
                first = col[torch.arange(len(pix), device=col.device), mask.int().argmax(1)]
                img[pix[:, 1].to(img.device), pix[:, 0].to(img.device)] = first.to(img)
                return img, stats

            return ctl

    return Control


def broken(fault: str):
    def wrap(mod):
        class Broken:
            MODE = mod.MODE

            @staticmethod
            def setup(run):
                import torch

                frame = mod.setup(run)
                first = []

                def bad(spec):
                    img, stats = frame(spec)
                    if fault == "stale":
                        first.append(img)
                        return first[0], stats
                    img = img.clone()
                    if fault == "half":
                        img[img.shape[0] // 2:] = 0
                    else:
                        img[..., 0] = torch.clamp(img[..., 0].int() + 24, max=255).to(img.dtype)
                    return img, stats

                return bad

        return Broken

    return wrap


def no_light_shadows(mod):
    class NoLightShadows:
        MODE = mod.MODE

        @staticmethod
        def setup(run):
            mix = run.mix
            run.mix = {**mix, "light_shadows": False}
            try:
                return mod.setup(run)
            finally:
                run.mix = mix

    return NoLightShadows


PLANTS = {"control": control, "stale": broken("stale"), "half": broken("half"),
          "altered": broken("altered"), "no_light_shadows": no_light_shadows}


@contextmanager
def planted(name: str | None):
    """Runs inside get the entries with the plant ``name`` (None: as they are)."""
    from render_bench import cell

    if name is None:
        yield
        return
    real = cell.entry
    cell.entry = lambda entry: PLANTS[name](real(entry))
    try:
        yield
    finally:
        cell.entry = real
