"""The port's differentiable raymarch against the JAX package's, float64 on
the CPU: `raymarch_raw_plain` (K6's plain version) against the JAX kernel
forward `make_vol_march_diff._forward` within 1e-11, and recombined
bit-identical to K5's plain march; `vol_march_bwd_plain` (K7's plain
version) against one `jax.vjp` of the JAX kernel pair in interpret mode
with the same seeded cotangents, d_in within 1e-9 of each lane's scale and
the five medium cotangents within 1e-9 relative; torch.autograd through
`make_vol_march_diff` on a weighted XYZA loss against jax.grad of the same
loss; a central finite difference on density_multiplier; finite gradients
with inactive and early-ending lanes. The setup is that of
tests/test_vol_adjoint.py (3 octaves, a 200-sample budget) with extra
grazing lanes that march long, jump the hole and saturate. The port's spec
takes the JAX spec's Chebyshev coefficients (its own fits agree with them
to 1e-9, tests/test_torch_volumetric.py), so that the comparison holds the
march and its backward, not the fits.

A difference that shows only at a tie of max(x, 0) (torch's clamp passes the
whole gradient there, jnp.maximum half) would not be a fault; no lane of
these inputs sits at one."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu.geometry.kerr import Kerr as JKerr
from gr_raytracer_tpu.ops import volumetric_adjoint as jva
from gr_raytracer_tpu.ops import volumetric_pallas as vp
from gr_raytracer_tpu.rendering.texture import BlackBodyMap as JBlackBody
from gr_raytracer_tpu_torch.geometry.kerr import Kerr
from gr_raytracer_tpu_torch.objects.volumetric_disc import VolumetricDisc
from gr_raytracer_tpu_torch.ops import volumetric_adjoint as va
from gr_raytracer_tpu_torch.ops import volumetric_march as vm
from gr_raytracer_tpu_torch.rendering.temperature import build_disc_temperature
from gr_raytracer_tpu_torch.rendering.texture import BlackBodyMap
from torch_port_scenes import CPU, F64, REPO, lane_relative_error, t

sys.path.insert(0, f"{REPO}/tests")
from test_volumetric_pallas import make_disc, make_inputs  # noqa: E402

DISC = dict(num_octaves=3, perlin_seed=3, max_steps=200, step_size=0.02, thickness=0.03,
            density_multiplier=500.0, brightness_reference_temperature=1000.0, absorption=0.3,
            scattering=0.4, noise_scale=(60.0, 2.0, 30.0), noise_offset=-0.2)
N_GRAZING = 64


def _port_spec(jspec):
    """The port's spec of the same disc, with the JAX spec's Chebyshev
    coefficients."""
    temp = build_disc_temperature(1.0, 0.45, 5000.0, 16.0, F64, CPU)
    disc = VolumetricDisc.create(4.05, 16.0, temp, BlackBodyMap.create(0.0, F64, CPU), dtype=F64, device=CPU,
                                 **DISC)
    geometry = Kerr(radius=torch.tensor(1.0, dtype=F64), a=torch.tensor(0.45, dtype=F64),
                    horizon_epsilon=torch.tensor(1e-4, dtype=F64))
    spec = vm.build_vol_spec(disc, geometry)
    fields = ("cx", "cy", "cz", "cx2", "cy2", "cz2")
    for f in fields:
        np.testing.assert_allclose(getattr(spec.tex, f), getattr(jspec.tex, f), rtol=1e-9, atol=1e-9)
    t4_scale = max(map(abs, jspec.temp.coeffs))
    np.testing.assert_allclose(spec.temp.coeffs, jspec.temp.coeffs, rtol=1e-9, atol=1e-9 * t4_scale)
    return spec._replace(
        temp=spec.temp._replace(coeffs=tuple(jspec.temp.coeffs)),
        tex=spec.tex._replace(**{f: tuple(getattr(jspec.tex, f)) for f in fields}),
    )


def _inputs(jdisc):
    """tests/test_vol_adjoint.py's 256 lanes and N_GRAZING lanes that enter
    the slab at a shallow angle, as numpy (active a bool array)."""
    ro, rd, obs, p_t, p_phi, active, ed = (np.asarray(v) for v in make_inputs(jdisc, n=256, seed=2))
    rng = np.random.default_rng(4)
    r = rng.uniform(5.0, 14.0, N_GRAZING)
    phi = rng.uniform(0, 2 * np.pi, N_GRAZING)
    g_ro = np.stack([r * np.cos(phi), r * np.sin(phi), np.full(N_GRAZING, 0.09)], axis=-1)
    to_center = -g_ro[:, :2] / r[:, None] + rng.normal(0, 0.15, (N_GRAZING, 2))
    g_rd = np.concatenate([to_center, -rng.uniform(0.01, 0.04, (N_GRAZING, 1))], axis=-1)
    g_rd /= np.linalg.norm(g_rd, axis=-1, keepdims=True)
    g_ed = np.asarray(jdisc.exit_distance(jnp.asarray(g_ro), jnp.asarray(g_rd)))
    cat = lambda a, b: np.concatenate([a, b])
    return (cat(ro, g_ro), cat(rd, g_rd), cat(obs, rng.uniform(0.9, 1.1, N_GRAZING)),
            cat(p_t, rng.uniform(0.8, 1.2, N_GRAZING)), cat(p_phi, rng.uniform(-0.5, 0.5, N_GRAZING)),
            cat(active, np.ones(N_GRAZING, bool)), cat(ed, g_ed))


@pytest.fixture(scope="module")
def ref():
    """The JAX side, once: the raw forward, one VJP with seeded cotangents
    and jax.grad of the weighted loss, in interpret mode with the rolled
    loops (UNROLL and BWD_UNROLL 1: bit-equivalent, and quicker to
    compile)."""
    geometry = JKerr(radius=jnp.asarray(1.0), a=jnp.asarray(0.45), horizon_epsilon=jnp.asarray(1e-4))
    jdisc = make_disc(JBlackBody.create(jnp.asarray(0.0)), geometry, max_steps=200).replace(num_octaves=3)
    jspec = vp.build_vol_spec(jdisc, geometry)
    ins = _inputs(jdisc)
    n = ins[0].shape[0]
    med = np.array([jspec.density_multiplier, jspec.noise_offset, jspec.absorption, jspec.scattering,
                    jspec.brightness_ref])
    rng = np.random.default_rng(11)
    cts = (rng.normal(size=(n, 3)), rng.normal(size=n), rng.normal(size=n), rng.normal(size=n))
    wts = rng.uniform(0.5, 1.5, (n, 4))
    ro, rd, obs, p_t, p_phi, active, ed = ins
    args = (*(jnp.asarray(m) for m in med), *(jnp.asarray(v) for v in (ro, rd, obs, p_t, p_phi)),
            jnp.asarray(active.astype(np.float64)), jnp.asarray(ed))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vp, "UNROLL", 1)
        mp.setattr(jva, "BWD_UNROLL", 1)
        march = jva.make_vol_march_diff(jspec, interpret=True)
        raw, vjp_fn = jax.vjp(march, *args)
        d_ct = vjp_fn(tuple(jnp.asarray(c) for c in cts))
        loss = lambda *a: jnp.sum(jva.combine_alpha(*march(*a)) * jnp.asarray(wts))
        d_loss = jax.grad(loss, argnums=tuple(range(10)))(*args)
    as_np = lambda vs: [np.asarray(v) for v in vs]
    return {"spec": _port_spec(jspec), "ins": ins, "med": med, "cts": cts, "wts": wts, "raw": as_np(raw),
            "d_ct": as_np(d_ct[:10]), "d_loss": as_np(d_loss)}


def _port_ins(ref):
    ro, rd, obs, p_t, p_phi, active, ed = ref["ins"]
    return (t(ro), t(rd), t(obs), t(p_t), t(p_phi), t(active), t(ed))


def _rel(got, want):
    return np.abs(np.asarray(got) - want) / np.maximum(np.abs(want), 1e-300)


def test_raw_forward_matches_jax_and_recombines_to_k5(ref):
    spec, ins = ref["spec"], _port_ins(ref)
    acc, t_fin, ws, wt = vm.raymarch_raw(spec, t(ref["med"]), *ins)  # CPU: the plain version
    got = np.concatenate([acc.numpy(), np.stack([t_fin.numpy(), ws.numpy(), wt.numpy()], 1)], 1)
    want = np.concatenate([ref["raw"][0], np.stack(ref["raw"][1:], 1)], 1)
    # Not 1e-12: XLA's and torch's exp and log differ by an ulp here and
    # there, and the blackbody's steep Wien side amplifies that; one
    # 10-sample lane differs by 7.6e-12 (tests/test_torch_volumetric.py
    # holds the same march to JAX's production kernel at 1e-9).
    assert lane_relative_error(want, got) <= 1e-11
    # With the spec's own medium, K6's results recombined are K5's XYZA bit
    # for bit (float64: σ_a + σ_s sums to the host's σ).
    xyza, samples = vm.raymarch_plain(spec, *ins)
    assert torch.equal(va.combine_alpha(acc, t_fin, ws, wt), xyza)
    # The lanes march long, jump the hole and saturate.
    assert samples.max() > 150 and (t_fin[ins[5]] < 1e-7).any() and (t_fin[ins[5]] > 0.5).any()
    assert vm.raw_launches == 0 and vm.launches == 0


def test_plain_backward_matches_the_jax_kernel_vjp(ref):
    spec, ins = ref["spec"], _port_ins(ref)
    med = t(ref["med"])
    acc, t_fin, _, _ = vm.raymarch_raw_plain(spec, med, *ins)
    ct_acc, ct_t, ct_ws, ct_wt = (t(c) for c in ref["cts"])
    cts = torch.stack([*ct_acc.unbind(1), ct_t, ct_ws, ct_wt, torch.sum(ct_acc * acc, -1), t_fin], 1)
    d_in, d_med = va.vol_march_bwd(spec, med, *ins, cts)  # CPU: the plain version
    want = np.concatenate([ref["d_ct"][5], ref["d_ct"][6], np.stack(ref["d_ct"][7:10], 1)], 1)
    assert lane_relative_error(want, d_in.numpy()) <= 1e-9
    assert _rel(d_med.sum(0).numpy(), np.array(ref["d_ct"][:5])).max() <= 1e-9
    # Inactive lanes get no cotangent; the sums are not trivially small.
    assert (d_in[~ins[5]] == 0).all() and (d_med[~ins[5]] == 0).all()
    assert (np.abs(np.array(ref["d_ct"][:5])) > 1e-3).all()
    assert va.launches == 0


def test_autograd_through_the_march_matches_jax_grad(ref):
    spec, ins = ref["spec"], _port_ins(ref)
    leaves = [t(ref["med"])] + [v.clone() for v in ins[:5]]
    for v in leaves:
        v.requires_grad_(True)
    march = va.make_vol_march_diff(spec)
    loss = torch.sum(va.combine_alpha(*march(*leaves, ins[5], ins[6])) * t(ref["wts"]))
    grads = torch.autograd.grad(loss, leaves)
    d_loss = ref["d_loss"]
    assert _rel(grads[0].numpy(), np.array(d_loss[:5])).max() <= 1e-9
    for got, want in zip(grads[1:], d_loss[5:10]):
        want = want.reshape(want.shape[0], -1)
        assert lane_relative_error(want, got.reshape(want.shape).numpy()) <= 1e-9


def test_density_multiplier_gradient_matches_central_difference(ref):
    """tests/test_vol_adjoint.py's FD check, on the port alone: the backward
    differentiates the discrete forward map, so central FD agrees tightly."""
    spec, ins = ref["spec"], _port_ins(ref)
    wts = t(ref["wts"])
    march = va.make_vol_march_diff(spec)
    loss = lambda m: torch.sum(va.combine_alpha(*march(m, *ins)) * wts)
    med = t(ref["med"]).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(med), med)
    h = 500.0 * 3e-6
    bump = torch.tensor([h, 0.0, 0.0, 0.0, 0.0], dtype=F64)
    with torch.no_grad():
        fd = float((loss(med + bump) - loss(med - bump)) / (2 * h))
    assert float(g[0]) == pytest.approx(fd, rel=2e-5, abs=1e-10)


def test_gradients_are_finite_with_inactive_and_parked_lanes(ref):
    """Inactive lanes parked on the disc axis (an unused event slot's zero
    payload), lanes that end at different samples (done lanes of a batch
    are evaluated at the mid-disc position) and lanes that miss: every
    gradient finite, the parked lanes' zero."""
    spec = ref["spec"]
    ro, rd, obs, p_t, p_phi, active, ed = (t(v) for v in ref["ins"])
    k = 40
    ro = torch.cat([ro[:k], torch.zeros((8, 3), dtype=F64)])
    rd = torch.cat([rd[:k], torch.tensor([[0.0, 0.0, -1.0]], dtype=F64).expand(8, 3)])
    pad = lambda v, x: torch.cat([v[:k], torch.full((8,), x, dtype=v.dtype)])
    ins = (ro, rd, pad(obs, 1.0), pad(p_t, 1.0), pad(p_phi, 0.0), pad(active, False), pad(ed, 0.0))
    leaves = [t(ref["med"])] + [v.clone() for v in ins[:5]]
    for v in leaves:
        v.requires_grad_(True)
    march = va.make_vol_march_diff(spec)
    xyza = va.combine_alpha(*march(*leaves, ins[5], ins[6]))
    grads = torch.autograd.grad(torch.log1p(torch.clamp(xyza[:, :3], min=0.0)).mean(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert (grads[0] != 0).all()
    assert all((g[k:] == 0).all() for g in grads[1:])


def test_the_march_rejects_bad_arguments(ref):
    spec, ins = ref["spec"], _port_ins(ref)
    med = t(ref["med"])
    with pytest.raises(ValueError):
        vm.raymarch_raw(spec, med[:4], *ins)
    with pytest.raises(ValueError):
        vm.raymarch_raw(spec, med.float(), *ins)
    with pytest.raises(ValueError):
        va.vol_march_bwd(spec, med, *ins, torch.zeros((ins[0].shape[0], 7), dtype=F64))


@pytest.mark.cuda
def test_cuda_kernels_match_their_plain_versions(ref):
    """Runs only on a machine with a card: K6 bit-identical to its plain
    version and K7 within 1e-9 of its plain version, in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = ref["spec"]
    ins = tuple(v.cuda() for v in _port_ins(ref))
    med = t(ref["med"]).cuda()
    before6, before7 = vm.raw_launches, va.launches
    got = vm.raymarch_raw(spec, med, *ins)
    want = vm.raymarch_raw_plain(spec, med, *ins)
    assert all(torch.equal(g, w) for g, w in zip(got, want)) and vm.raw_launches == before6 + 1
    ct_acc, ct_t, ct_ws, ct_wt = (t(c).cuda() for c in ref["cts"])
    cts = torch.stack([*ct_acc.unbind(1), ct_t, ct_ws, ct_wt, torch.sum(ct_acc * want[0], -1), want[1]], 1)
    d_in, d_med = va.vol_march_bwd(spec, med, *ins, cts)
    p_in, p_med = va.vol_march_bwd_plain(spec, med, *ins, cts)
    assert va.launches == before7 + 1
    assert lane_relative_error(p_in.cpu().numpy(), d_in.cpu().numpy()) <= 1e-9
    assert _rel(d_med.sum(0).cpu().numpy(), p_med.sum(0).cpu().numpy()).max() <= 1e-9
