"""PyTorch port: the slice end to end against ``gple_tpu``.

Three ``make_step_fn`` steps and two ``_tick_core`` ticks from the
``__graft_entry__._example_state`` construction at N = 64, on the same points
and extra cloud in both packages, with the limits ``tests/test_sharding.py``
holds the JAX step to: points 1e-12, rho 1e-8, alpha 1e-8.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gple_tpu import driver as JD
from gple_tpu.parallel.sharding import make_step_fn as jax_make_step_fn
from gple_tpu import storage as JS
from gple_tpu.storage import Density as JDensity
from gple_tpu_torch import convert
from gple_tpu_torch import driver as TD
from gple_tpu_torch import storage as TS
from gple_tpu_torch.entry import example_extra, example_state
from gple_tpu_torch.ops import gram_kernels as GK
from gple_tpu_torch.parallel.sharding import make_step_fn
from test_torch_kernels import _warm_torch_exp, one_torch_thread  # noqa: F401 (fixtures)

MODEL, MASS, DT = "SAC", 2000.0, 1.0
N = 64
TOL_POINTS, TOL_RHO, TOL_ALPHA = 1e-12, 1e-8, 1e-8


def check(port_density, port_gps, jax_density, jax_gps, where):
    np.testing.assert_allclose(port_density.points.numpy(), np.asarray(jax_density.points),
                               rtol=0, atol=TOL_POINTS, err_msg=f"{where}: points")
    np.testing.assert_allclose(port_density.rho.numpy(), np.asarray(jax_density.rho),
                               rtol=0, atol=TOL_RHO, err_msg=f"{where}: rho")
    np.testing.assert_allclose(port_gps.diag.alpha.numpy(), np.asarray(jax_gps.diag.alpha),
                               rtol=0, atol=TOL_ALPHA, err_msg=f"{where}: alpha")
    np.testing.assert_allclose(port_gps.offdiag.v.numpy(), np.asarray(jax_gps.offdiag.v),
                               rtol=0, atol=TOL_ALPHA, err_msg=f"{where}: v")


@pytest.fixture(scope="module")
def start():
    jd, jg = graft._example_state(N)
    td, tg = example_state(N, "cpu", pts0=np.asarray(jd.points[0]))
    return jd, jg, td, tg


def test_example_state_matches_graft_entry(start):
    jd, jg, td, tg = start
    check(td, tg, jd, jg, "example state")
    np.testing.assert_allclose(tg.population().numpy(), np.asarray(jg.population()),
                               rtol=1e-12)


def test_three_steps_match(start):
    jd, jg, td, tg = start
    jstep = jax.jit(jax_make_step_fn(MODEL, MASS, DT))
    tstep = make_step_fn(MODEL, MASS, DT)
    for i in range(3):
        jd, jg = jstep(jd, jg)
        td, tg = tstep(td, tg)
        check(td, tg, jd, jg, f"step {i}")
    assert td.points.is_inference()  # the step runs under torch.inference_mode


def test_two_ticks_match(start):
    jd, jg, td, tg = start
    extra_t = example_extra(5 * N, "cpu", generator=torch.Generator().manual_seed(1))
    ex = convert.to_numpy(extra_t)
    extra_j = JDensity(points=jnp.asarray(ex.points), rho=jnp.asarray(ex.rho),
                       active=jnp.asarray(ex.active))
    jtick = jax.jit(partial(JD._tick_core, MODEL, MASS, DT), static_argnums=(5, 6, 7, 8, 9))
    for i in range(2):
        jd, extra_j, jsmall, jg = jtick(jd, extra_j, jg, jg.diag.params, jg.offdiag.params,
                                        JD.gp_dist_all_nocut, "none", 0, 2.0, True)
        td, extra_t, tsmall, tg = TD._tick_core(
            MODEL, MASS, DT, td, extra_t, tg, tg.diag.params, tg.offdiag.params,
            TD.gp_dist_all_nocut, "none", 0, 2.0, True)
        check(td, tg, jd, jg, f"tick {i}")
        np.testing.assert_allclose(extra_t.points.numpy(), np.asarray(extra_j.points),
                                   rtol=0, atol=TOL_POINTS)
        np.testing.assert_allclose(extra_t.rho.numpy(), np.asarray(extra_j.rho),
                                   rtol=0, atol=TOL_RHO)
        np.testing.assert_array_equal(tsmall.numpy(), np.asarray(jsmall))


def test_slice_on_cpu_launches_no_kernel(start):
    _, _, td, tg = start
    before = dict(GK.LAUNCHES)
    make_step_fn(MODEL, MASS, DT)(td, tg)
    assert GK.LAUNCHES == before


def test_tick_core_unported_options_raise(start):
    """Every option of the tick is ported now (the name is the record of
    when two were not): per-tick moment tracking of every element, the
    booster (8 extra points join the coherence fit, at coherence divisor 6)
    and the coherence-only cutoff, together for two ticks against JAX's (one
    compile; the flag tests cover tracking of the coherence alone)."""
    jd0, jg0, td0, tg0 = start
    extra_t0 = example_extra(5 * N, "cpu", generator=torch.Generator().manual_seed(2))
    ex = convert.to_numpy(extra_t0)
    extra_j0 = JDensity(points=jnp.asarray(ex.points), rho=jnp.asarray(ex.rho),
                        active=jnp.asarray(ex.active))
    jtick = jax.jit(partial(JD._tick_core, MODEL, MASS, DT), static_argnums=(5, 6, 7, 8, 9))
    for track, k, div, cut in (("all", 8, 6.0, "coh"),):
        jd, jg, extra_j, td, tg, extra_t = jd0, jg0, extra_j0, td0, tg0, extra_t0
        if k:
            # the booster's states carry N + k coherence points from the start
            jg = JS.fit_gp_states(jg0.diag.params, jg0.offdiag.params, jd0,
                                  off_extra=JD._off_extra_slice(extra_j0, k), block_diag=True)
            tg = TS.fit_gp_states(tg0.diag.params, tg0.offdiag.params, td0,
                                  off_extra=TD._off_extra_slice(extra_t0, k), block_diag=True)
            check(td, tg, jd, jg, "booster fit")
        for i in range(2):
            jd, extra_j, jsmall, jg = jtick(jd, extra_j, jg, jg0.diag.params,
                                            jg0.offdiag.params, JD._evolve_dist_for(cut),
                                            track, k, div, True)
            td, extra_t, tsmall, tg = TD._tick_core(
                MODEL, MASS, DT, td, extra_t, tg, tg0.diag.params, tg0.offdiag.params,
                TD._evolve_dist_for(cut), track, k, div, True)
            check(td, tg, jd, jg, f"{track}/{k}: tick {i}")
            np.testing.assert_array_equal(tsmall.numpy(), np.asarray(jsmall))
            assert tg.offdiag.features.shape[0] == N + k
            for name in ("real_lengths", "imag_lengths", "real_magnitude"):
                np.testing.assert_allclose(getattr(tg.offdiag.params, name).numpy(),
                                           np.asarray(getattr(jg.offdiag.params, name)),
                                           rtol=1e-12, err_msg=name)
            np.testing.assert_allclose(tg.diag.params.lengths.numpy(),
                                       np.asarray(jg.diag.params.lengths), rtol=1e-12)


def test_example_state_is_seeded():
    a, _ = example_state(16, "cpu", generator=torch.Generator().manual_seed(5))
    b, _ = example_state(16, "cpu", generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.points, b.points) and torch.equal(a.rho, b.rho)
    assert a.points.shape == (3, 16, 2) and a.active.all()
    extra = example_extra(80, "cpu", generator=torch.Generator().manual_seed(5))
    assert extra.points.shape == (3, 80, 2) and extra.rho.shape == (3, 80, 2)
