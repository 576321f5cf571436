"""Checkpoint / resume of a trajectory (counterpart of :mod:`gple_tpu.io.checkpoint`).

The archive is the JAX package's ``.npz`` schema, field for field and dtype
for dtype, so either package resumes the other's run: the clouds (points,
labels, active flags, the extra clouds), the optimizer's parameters and
analytic magnitudes, the ladder's warm augmented-Lagrangian multipliers
``al_lam`` (a (0,) array before the first reoptimization), the Metropolis
tuning, the conserved targets, the tick, the last optimizer result, the
coherence divisor of the fit-health backoff, the booster size ``coh_k``
(always 0 here: the booster is not ported) and the population numerator
``pop_sum0``.

The random key.  The JAX package stores its ``jax.random`` key, a
``uint32[2]`` array; the port's key is an integer seed
(:class:`gple_tpu_torch.sampler.keys.RandomKeys`, 63 bits when the port
derives it, up to 64 when read from a file).  The seed is stored as that
array, high word first: ``key = (seed >> 32, seed & 0xffffffff)``, which is
the key ``jax.random.PRNGKey(seed)`` makes from the same integer; a key is
read back as ``seed = key[0] << 32 | key[1]``.  The mapping is exact both
ways, so a checkpoint resumes the port's stream exactly and a JAX key passes
through the port unchanged; the two packages' random streams from one key
differ, after a resume as from the start.

The restore refits the GP states from the restored clouds and parameters
and takes the drift references from that fit (``_record_fit_ref``), as the
JAX package does.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gple_tpu_torch import observables as OBS
from gple_tpu_torch.gp.opt import Optimizer, OptResult
from gple_tpu_torch.sampler.keys import RandomKeys
from gple_tpu_torch.sampler.mc import MCParameters
from gple_tpu_torch.storage import DIAG_INDICES, Density


def key_from_seed(seed: int) -> np.ndarray:
    """The ``uint32[2]`` key array of a seed below 2^64 (high word first)."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)


def seed_from_key(key) -> int:
    """The seed of a ``uint32[2]`` key array (high word first)."""
    hi, lo = (int(v) for v in np.asarray(key, dtype=np.uint32).reshape(2))
    return (hi << 32) | lo


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(path: str, driver, tick: int) -> None:
    """Persist a :class:`gple_tpu_torch.driver.GPLEDriver` mid-run."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    opt = driver.optimizer
    np.savez_compressed(
        path,
        tick=tick,
        key=key_from_seed(driver.rng.seed),
        points=_host(driver.density.points),
        rho=_host(driver.density.rho),
        active=_host(driver.density.active),
        extra_points=_host(driver.extra.points),
        extra_rho=_host(driver.extra.rho),
        diag_lengths=np.asarray(opt.diag_lengths),
        off_params=np.asarray(opt.off_params),
        diag_magnitudes=np.asarray(opt.diag_magnitudes),
        off_magnitude=float(opt.off_magnitude),
        total_energy=driver.total_energy,
        purity=driver.purity,
        purity_ratio=driver.purity_ratio,
        mc_steps=np.asarray([p.num_steps for p in driver.mc_params]),
        mc_displacements=np.asarray([p.displacement for p in driver.mc_params]),
        al_lam=np.asarray(opt._al_lam) if opt._al_lam is not None else np.zeros((0,)),
        opt_error=float(driver.opt_result.error),
        opt_type=str(driver.opt_result.opt_type),
        coh_div_eff=float(driver._coh_div_eff),
        coh_k=0,
        pop_sum0=float(driver._pop_sum0),
    )


@torch.inference_mode()
def load_checkpoint(path: str, driver) -> int:
    """Restore a driver from a checkpoint of either package; returns its tick."""
    t0 = time.perf_counter()
    cfg, dev = driver.cfg, driver.device

    def t(a):
        return torch.tensor(np.asarray(a), device=dev)

    with np.load(path) as z:
        if "coh_k" in z and int(z["coh_k"]) > 0:
            raise NotImplementedError("load_checkpoint: the checkpoint carries a coherence "
                                      "booster (coh_k > 0), which is not ported (ROADMAP "
                                      "Queue A item 13)")
        driver.rng = RandomKeys(seed_from_key(z["key"]), dev)
        active = t(z["active"])
        driver.density = Density(points=t(z["points"]), rho=t(z["rho"]), active=active)
        driver.extra = Density(points=t(z["extra_points"]), rho=t(z["extra_rho"]),
                               active=active)
        driver.total_energy = float(z["total_energy"])
        driver.purity = float(z["purity"])
        driver.purity_ratio = float(z["purity_ratio"])
        driver.optimizer = Optimizer(
            model=cfg.model, mass=cfg.mass, total_energy=driver.total_energy,
            purity=driver.purity, sigma_r0=np.asarray(cfg.sigma_r0),
            diag_lengths=np.array(z["diag_lengths"]), off_params=np.array(z["off_params"]),
            diag_magnitudes=np.array(z["diag_magnitudes"]),
            off_magnitude=float(z["off_magnitude"]), lbfgs_steps=cfg.opt_steps_reopt,
            corr_bounds=driver._corr_bounds(), opt_mode=cfg.opt_mode,
            off_len_div=cfg.coh_len_div, device=dev)
        driver.mc_params = [MCParameters(num_steps=int(s), displacement=float(d))
                            for s, d in zip(z["mc_steps"], z["mc_displacements"])]
        if "al_lam" in z and z["al_lam"].size:
            driver.optimizer._al_lam = np.array(z["al_lam"])
        if "coh_div_eff" in z:
            driver._coh_div_eff = float(z["coh_div_eff"])
            driver.optimizer.off_len_div = driver._coh_div_eff
        if "pop_sum0" in z and float(z["pop_sum0"]) != 0.0:
            driver._pop_sum0 = float(z["pop_sum0"])
        else:
            driver._pop_sum0 = float(torch.sum(driver.density.rho[list(DIAG_INDICES)][..., 0]))
        tick = int(z["tick"])
        opt_error = float(z["opt_error"]) if "opt_error" in z else 0.0
        opt_type = str(z["opt_type"]) if "opt_type" in z else "resumed"
    t1 = time.perf_counter()
    driver.gps = driver._refit(driver.density)
    mc_pur = float(torch.sum(OBS.purity_each_element(driver.density)))
    driver._record_fit_ref(driver._target_purity(mc_pur))
    driver.opt_result = OptResult(error=opt_error, steps=[], opt_type=opt_type)
    driver._log(f"restore phases: npz={t1 - t0:.1f}s refit={time.perf_counter() - t1:.1f}s")
    return tick
