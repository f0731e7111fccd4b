"""Faults planted underneath the timed path, and the precision control.

Used by the CPU tests, which see ``correct`` come out false under each
fault a cell can have, and by ``calibrate.py``, whose readings on the
chip set the upper end of each check's limit. A run of the benchmark
plants nothing.

* ``frozen``: the optimizer step returns the state unchanged.
* ``half_batch``: half of each batch is left out; the loss is the mean
  over the rest (render: the left-out views come back empty).
* ``altered``: the first view's image is replaced by the second's where
  it is produced.
* ``stale`` (render): every call returns the first call's images.
* ``no_exchange`` (dp): the gradient all-reduce is left out; each rank
  steps on its own gradient.
* ``control``: the plain reference put in the program's place, its data
  path (attributes, texels, barycentrics once computed, the image) in
  bfloat16 and its geometry in float32: the step below float32 that a
  later change could be tempted to take.
"""

from contextlib import contextmanager

import torch

KINDS = {"train": ("frozen", "half_batch", "altered", "control"),
         "dp": ("frozen", "half_batch", "altered", "no_exchange", "control"),
         "render": ("stale", "half_batch", "altered", "control")}


def _patch(patches, obj, name, value):
    patches.append((obj, name, getattr(obj, name)))
    setattr(obj, name, value)


@contextmanager
def planted(name, cell):
    """Plant fault `name` (None: nothing) for the duration of the block."""
    if name is None:
        yield
        return
    from perfbench import training

    patches = []
    mod = cell.config_module
    orig_render = mod.render
    orig_init = training.Fitting.__init__
    try:
        if name == "altered":
            def render(scene, params, views, resolution):
                img = orig_render(scene, params, views, resolution)
                return torch.cat([img[1:2], img[1:]])
            _patch(patches, mod, "render", render)
        elif name == "half_batch" and cell.traffic["kind"] == "render":
            def render(scene, params, views, resolution):
                half = views.shape[0] // 2
                img = orig_render(scene, params, views[:half], resolution)
                return torch.cat([img, img.new_zeros((views.shape[0] - half,) + img.shape[1:])])
            _patch(patches, mod, "render", render)
        elif name == "half_batch":
            def init(self, *a, **k):
                orig_init(self, *a, **k)
                self.order = self.order[:, :self.B // 2].contiguous()
            _patch(patches, training.Fitting, "__init__", init)
        elif name == "frozen":
            def init(self, *a, **k):
                orig_init(self, *a, **k)
                self.opt.step = lambda *_, **__: None
            _patch(patches, training.Fitting, "__init__", init)
        elif name == "stale":
            first = []

            def render(scene, params, views, resolution):
                if not first:
                    first.append(orig_render(scene, params, views, resolution))
                return first[0]
            _patch(patches, mod, "render", render)
        elif name == "no_exchange":
            from nvdiffrast_tpu_torch.parallel import shard

            _patch(patches, shard, "all_reduce_sum",
                   lambda tensors, group: [t.clone() for t in tensors])
        elif name == "control":
            _patch(patches, mod, "render", _reference_render(cell))
        else:
            raise ValueError(f"unknown fault {name!r}")
        yield
    finally:
        for obj, attr, value in reversed(patches):
            setattr(obj, attr, value)


def _reference_render(cell, geom=torch.float32, data=torch.bfloat16):
    """A render call of the program's signature computed by the plain
    reference, differentiable in the parameters."""
    ref = cell.ref_module
    meshes = {}

    def render(scene, params, views, resolution):
        dev = views.device
        if dev not in meshes:
            meshes[dev] = ref.mesh(scene["arrays"], dev)
        m = meshes[dev]
        shared = ref.prepare(m, params, cell.config, data)
        H, W = resolution
        return torch.stack([
            ref.render_view(m, params, shared, v, resolution, cell.config, geom, data)
            .float().reshape(H, W, -1) for v in views])
    return render
