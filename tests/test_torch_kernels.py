"""PyTorch port: the kernel wrappers' dispatch, and the CUDA kernels on a GPU.

This file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_kernels.py

On the CPU the wrappers take the plain versions; the tests marked ``gpu``
compare each CUDA kernel with its plain version on the card and skip where
there is no CUDA device or no ``nvcc``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gple_tpu_torch.ops import gram_kernels as GK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """The first multithreaded CPU ``torch.exp`` of a process is occasionally
    inexact on some hosts (seen: 3e-9 in float64, 1e-4 in float32, in about
    one process in four); every later call is exact.  One warm-up call over
    all intra-op threads keeps the comparisons below on the exact path."""
    for dtype in (torch.float32, torch.float64):
        torch.exp(-torch.linspace(0.0, 40.0, 1 << 20, dtype=dtype))


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def cloud(rng, *shape):
    """Points shaped like the example cloud (r0 + sigma * N(0, 1))."""
    return np.array([-10.0, 30.0]) + rng.normal(size=shape + (2,)) * np.array([1 / 3, 1.5])


# -- dispatch ----------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_without_launching():
    rng = np.random.default_rng(4)
    before = dict(GK.LAUNCHES)
    lengths, xa = t64([0.5, 1.0]), t64(cloud(rng, 7))
    out = GK.gram_rbf(lengths, xa, xa)
    np.testing.assert_array_equal(out.numpy(), GK.gram_plain(lengths, xa, xa).numpy())
    GK.predict_mean_rbf(lengths, xa, xa, torch.ones(7, 1, dtype=torch.float64))
    assert GK.LAUNCHES == before


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(4, 2, device="meta", dtype=torch.float64)
    l = torch.empty(2, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="no kernel"):
        GK.gram_rbf(l, x, x)
    with pytest.raises(ValueError, match="no kernel"):
        GK.predict_mean_rbf(l, x, x, torch.empty(4, 1, device="meta", dtype=torch.float64))


@pytest.mark.parametrize("launcher", ["gram", "predict"])
def test_cuda_launchers_reject_cpu_tensors(launcher):
    x = torch.zeros(1, 4, 2, dtype=torch.float64)
    l = torch.ones(1, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="expected CUDA"):
        if launcher == "gram":
            GK.gram_cuda(l, x, x)
        else:
            GK.predict_mean_cuda(l, x, x, torch.zeros(1, 4, 1, dtype=torch.float64))


def test_batch_flattening_keeps_broadcast_operands_as_views():
    lengths = torch.ones(3, 2, dtype=torch.float64)
    x = torch.zeros(5, 2, dtype=torch.float64)
    batch, (l2, a2, b2) = GK._flat_batch((lengths, 1), (x, 2), (x, 2))
    assert batch == (3,)
    assert a2.shape == (3, 5, 2) and a2.stride() == (0, 2, 1)
    assert a2.data_ptr() == x.data_ptr() and l2.shape == (3, 2)


def test_kernel_route_reshapes_batched_operands(monkeypatch):
    """The CUDA route's batch flattening, with a stand-in for the launch."""
    rng = np.random.default_rng(5)
    calls = []

    def fake_gram(l, a, b):
        assert l.dim() == 2 and a.dim() == 3 and b.dim() == 3
        calls.append(a.shape)
        return GK.gram_plain(l, a, b)

    def fake_predict(l, t, r, al):
        assert t.dim() == 3 and al.dim() == 3
        calls.append(t.shape)
        return GK.predict_mean_plain(l, t, r, al)

    monkeypatch.setattr(GK, "gram_cuda", fake_gram)
    monkeypatch.setattr(GK, "predict_mean_cuda", fake_predict)
    monkeypatch.setattr(GK, "_route", lambda name, t: True)
    lengths = t64(rng.uniform(0.3, 2.0, size=(4, 2)))
    xa, xb = t64(cloud(rng, 9)), t64(cloud(rng, 4, 6))
    alpha = t64(rng.normal(size=(6, 2)))
    g = GK.gram_rbf(lengths, xa, xb)
    p = GK.predict_mean_rbf(lengths, xa, xb, alpha)
    assert calls == [(4, 9, 2), (4, 9, 2)]
    np.testing.assert_array_equal(g.numpy(), GK.gram_plain(lengths, xa, xb).numpy())
    np.testing.assert_allclose(p.numpy(), (GK.gram_plain(lengths, xa, xb) @ alpha).numpy(),
                               rtol=0, atol=1e-14)


def test_import_pulls_in_neither_jax_nor_gple_tpu():
    code = (
        "import sys, gple_tpu_torch, gple_tpu_torch.convert, gple_tpu_torch.entry, "
        "gple_tpu_torch.driver, gple_tpu_torch.parallel.sharding, "
        "gple_tpu_torch.ops._build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'gple_tpu' or m.startswith('gple_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-2000:]


# -- the CUDA kernels on the card -------------------------------------------------------

@pytest.fixture
def cuda_device():
    """A CUDA device with a compiler, or a skip (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gple_tpu_torch.ops import _build

    try:
        _build.find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-precision reference matmuls
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
def test_gram_kernel_matches_plain_on_gpu(cuda_device, dtype, tol):
    rng = np.random.default_rng(9)
    lengths = torch.tensor(rng.uniform(0.3, 2.0, size=(5, 2)), dtype=dtype, device=cuda_device)
    xa = torch.tensor(cloud(rng, 5, 301), dtype=dtype, device=cuda_device)
    xb = torch.tensor(cloud(rng, 203), dtype=dtype, device=cuda_device).expand(5, 203, 2)
    before = GK.LAUNCHES["rbf_gram"]
    out = GK.gram_rbf(lengths, xa, xb)
    torch.cuda.synchronize()
    assert GK.LAUNCHES["rbf_gram"] == before + 1
    ref = GK.gram_plain(lengths, xa, xb)
    assert (out - ref).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 2])
def test_predict_kernel_matches_plain_on_gpu(cuda_device, c):
    rng = np.random.default_rng(10)
    dev, dt = cuda_device, torch.float64
    lengths = torch.tensor(rng.uniform(0.3, 2.0, size=(3, 2)), dtype=dt, device=dev)
    xt = torch.tensor(cloud(rng, 3, 1000), dtype=dt, device=dev)
    xtr = torch.tensor(cloud(rng, 3, 333), dtype=dt, device=dev)
    alpha = torch.tensor(rng.normal(size=(3, 333, c)), dtype=dt, device=dev)
    before = GK.LAUNCHES["rbf_predict_mean"]
    out = GK.predict_mean_rbf(lengths, xt, xtr, alpha)
    torch.cuda.synchronize()
    assert GK.LAUNCHES["rbf_predict_mean"] == before + 1
    ref = GK.predict_mean_plain(lengths, xt, xtr, alpha)
    assert (out - ref).abs().max().item() <= 1e-10 * ref.abs().max().item()
