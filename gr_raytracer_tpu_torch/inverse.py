"""Inverse rendering: fit physical scene parameters to a target image (port
of gr_raytracer_tpu/inverse.py).

The whole pipeline (camera, march, shading, fold) is differentiable on the
kernel path (rendering/fast_path.trace_rays_fast_diff), so a scalar image
loss drives torch.autograd on physical parameters: spin, camera pose, disc
temperature. On a volumetric scene the raymarch is differentiable in the
five medium parameters (fast_path.trace_rays_fast_vol_diff;
`medium_render` fits density_multiplier and absorption). A scene outside
fast_path.supports_diff (a KerrBL or Schwarzschild scene with a sphere, a
texture that is not opaque, a gas disc whose axis is not z) takes the
RKF45 route: scene.trace_rays with IntegrationConfig(differentiable=True)
(presets.build_kerr_flagship(..., differentiable=True) sets it), whose
loop runs in checkpointed blocks, and VolumetricDisc(differentiable=True)
for its raymarch.

Loss design: the renderer returns HDR CIE XYZ radiance spanning ~6 decades.
A plain L2 loss is dominated by the brightest pixels; log1p keeps relative
sensitivity uniform (d log1p(c)/dθ = (dc/dθ)/(1+c)).

The optimizer is torch.optim.Adam behind an optional global-norm clip and
a learning-rate schedule: `fit(..., clip_norm=1.0,
learning_rate=cosine_decay_schedule(1e-2, 400, 0.01))` is optax's
chain(clip_by_global_norm(1.0), adam(cosine_decay_schedule(1e-2, 400,
0.01))).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping, Optional

import torch


def log_radiance(color):
    """log1p of the XYZ radiance channels of an [N, 4] XYZA buffer."""
    return torch.log1p(color[..., :3])


def image_loss(rendered, target):
    """Mean squared log-radiance error between two [N, 4] XYZA buffers
    (`target` may already be log-radiance of shape [N, 3])."""
    t = target if target.shape[-1] == 3 else log_radiance(target)
    return torch.mean((log_radiance(rendered) - t) ** 2)


def pyramid_image_loss(rows: int, cols: int, pools=(1, 4, 16)):
    """Multiscale log-radiance loss for geometric parameters (camera pose,
    spin): the average of `image_loss` over average-pooled copies of the
    image. A pixelwise loss leaves a misregistered start on a plateau;
    pooling by p makes the same displacement ~p× smaller in pooled pixels.
    Use as `fit(..., loss_fn=pyramid_image_loss(rows, cols))` on
    [rows·cols, 4] buffers."""
    pools = tuple(int(p) for p in pools)
    for p in pools:
        if rows % p or cols % p:
            raise ValueError(f"pool {p} must divide image shape {rows}x{cols}")

    def pooled(img, p):
        if p == 1:
            return img
        return img.reshape(rows // p, p, cols // p, p, 3).mean(dim=(1, 3))

    def loss(rendered, target):
        r = log_radiance(rendered).reshape(rows, cols, 3)
        t = target if target.shape[-1] == 3 else log_radiance(target)
        t = t.reshape(rows, cols, 3)
        terms = [torch.mean((pooled(r, p) - pooled(t, p)) ** 2) for p in pools]
        return sum(terms) / len(pools)

    return loss


def disc_medium(obj):
    """The five medium parameters of a VolumetricDisc as one [5] tensor
    (volumetric_march.MED_NAMES): density_multiplier, noise_offset,
    absorption, scattering, brightness_reference_temperature."""
    return torch.stack([
        obj.density_multiplier, obj.noise_offset, obj.absorption, obj.scattering,
        obj.brightness_reference_temperature,
    ]).detach()


def medium_render(scene, positions, momenta, spec=None):
    """render_fn(params) for `fit` on a volumetric scene with the
    reparametrisation of scripts/grad_scale_probe.py --vol: density_multiplier
    = exp(params["log_dm"]), absorption = exp(params["log_ab"]), the other
    three at the disc's own values."""
    from gr_raytracer_tpu_torch.rendering import fast_path

    base = disc_medium(scene.objects[0]).to(positions.dtype)
    if spec is None:
        spec = fast_path.scene_kernel_spec(scene)

    def render(params):
        med = torch.stack([torch.exp(params["log_dm"]), base[1], torch.exp(params["log_ab"]), base[3], base[4]])
        return fast_path.trace_rays_fast_vol_diff(scene, med, positions, momenta, spec).color

    return render


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """lr(t) = init·((1 − α)·½(1 + cos(π·min(t, T)/T)) + α) at update count
    t (0 for the first update), optax.cosine_decay_schedule's rule."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps)) + alpha)

    return schedule


class Optimizer:
    """Global-norm clip (optional), then Adam on the trainable keys of a
    parameter dict, with the learning rate set from a schedule before every
    update.

    The clip reads the global norm of every gradient given, frozen keys
    included, as optax.clip_by_global_norm does ahead of optax.masked;
    frozen keys never move."""

    def __init__(self, params: Mapping, trainable: Iterable[str], learning_rate=3e-2,
                 clip_norm: Optional[float] = None):
        trainable = frozenset(trainable)
        unknown = trainable - set(params)
        if unknown:
            raise ValueError(f"trainable names not in params: {sorted(unknown)}")
        self.params = params
        self.trainable = [k for k in params if k in trainable]
        self.schedule = learning_rate if callable(learning_rate) else (lambda _t, lr=learning_rate: lr)
        self.clip_norm = clip_norm
        self.count = 0
        self.opt = torch.optim.Adam([params[k] for k in self.trainable], lr=self.schedule(0))

    def update(self, grads: Mapping):
        """One update from `grads` (a dict of tensors or None)."""
        scale = None
        if self.clip_norm is not None:
            sq = [torch.sum(g.detach() ** 2) for g in grads.values() if g is not None]
            g_norm = torch.sqrt(sum(sq)) if sq else None
            if g_norm is not None and not bool(g_norm < self.clip_norm):
                scale = g_norm
        for k in self.trainable:
            g = grads.get(k)
            g = torch.zeros_like(self.params[k]) if g is None else g.detach()
            self.params[k].grad = g if scale is None else (g / scale) * self.clip_norm
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1


def fit(
    render_fn: Callable,
    init_params: Mapping,
    target,
    trainable: Iterable[str],
    steps: int = 50,
    learning_rate=3e-2,
    clip_norm: Optional[float] = None,
    loss_fn: Optional[Callable] = None,
    callback: Optional[Callable] = None,
):
    """Gradient-descend the `trainable` keys of a parameter dict to match a
    target image.

    render_fn(params) -> [N, 4] XYZA radiance buffer.
    target: [N, 4] XYZA buffer (or [N, 3] log-radiance) to match.
    trainable: parameter names that move; every other floating leaf is
        frozen (it is still differentiated, and counts in the clip's norm).
    learning_rate: a float or a schedule count -> float
        (cosine_decay_schedule); clip_norm: global-norm clip ahead of Adam.
    loss_fn(rendered, target) -> scalar; default `image_loss`.
    callback(step, loss, params, grads): optional per-step observer, called
        after the update with the gradients that made it.

    Returns (params, losses) with losses a list of per-step floats.
    """
    loss_fn = loss_fn or image_loss
    params = {
        k: (v.detach().clone().requires_grad_(True) if torch.is_floating_point(v) else v)
        for k, v in init_params.items()
    }
    leaves = [k for k, v in params.items() if isinstance(v, torch.Tensor) and v.requires_grad]
    opt = Optimizer(params, trainable, learning_rate, clip_norm)
    t = torch.as_tensor(target)
    losses = []
    for i in range(steps):
        loss = loss_fn(render_fn(params), t)
        g = torch.autograd.grad(loss, [params[k] for k in leaves], allow_unused=True)
        grads = dict(zip(leaves, g))
        opt.update(grads)
        losses.append(float(loss.detach()))
        if callback is not None:
            callback(i, losses[-1], params, grads)
    return params, losses
