"""PyTorch port: the kernel wrappers' dispatch, and the CUDA kernels on a GPU.

This file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_kernels.py

On the CPU the wrappers take the plain versions; the tests marked ``gpu``
compare each CUDA kernel with its plain version on the card and skip where
there is no CUDA device or no ``nvcc``.
"""

import contextlib
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from gple_tpu_torch.ops import _build
from gple_tpu_torch.ops import gram_kernels as GK
from gple_tpu_torch.ops import kernel_bench as KB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """The first multithreaded CPU ``torch.exp`` of a process is occasionally
    inexact on some hosts (seen: 3e-9 in float64, 1e-4 in float32, in about
    one process in four); every later call is exact.  One warm-up call over
    all intra-op threads keeps the comparisons below on the exact path."""
    for dtype in (torch.float32, torch.float64):
        torch.exp(-torch.linspace(0.0, 40.0, 1 << 20, dtype=dtype))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The driver, the ladder and the oracles are thousands of small tensor
    ops; with one process per core (the suite's workers), intra-op threads
    only contend for the cores.  One intra-op thread for this module and for
    every module that imports this fixture; the previous count after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# -- launch plans, range checks and the C interface ---------------------------------------

PLAN_SHAPES = [(2, 10240, 1024), (3, 10240, 1024), (2, 51200, 1024), (3, 51200, 1024),
               (3, 1000, 333), (1, 1, 1), (4, 300, 31), (1, 7, 5000), (2, 256, 100000)]


@pytest.mark.parametrize("batch,m,n", PLAN_SHAPES)
def test_predict_plan_covers_the_training_set(batch, m, n):
    splits, chunk = GK.predict_plan(batch, m, n, 132)
    assert 1 <= chunk <= GK.PREDICT_MAX_CHUNK and 1 <= splits <= 65535
    assert (splits - 1) * chunk < n <= splits * chunk  # no empty chunk, nothing left over
    assert splits == 1 or chunk >= min(n, GK._MIN_CHUNK)


@pytest.mark.parametrize("batch,m", [(2, 10240), (3, 10240), (2, 51200), (3, 51200)])
def test_predict_plan_fills_the_card_at_main_path_shapes(batch, m):
    """Every SM gets at least 8 blocks (32 warps) at the tick's query fans,
    and the busiest SM has at most 10% more work than the mean."""
    splits, chunk = GK.predict_plan(batch, m, 1024, 132)
    blocks = batch * -(-m // GK.PREDICT_ROWS_PER_BLOCK) * splits
    assert blocks >= 8 * 132
    busiest = -(-blocks // 132) * chunk
    assert busiest <= 1.1 * blocks * chunk / 132


def test_gram_grid_and_its_range_checks():
    assert GK.gram_grid(3, 10240, 1024, 2, torch.float64) == (16, 80, 3)
    assert GK.gram_grid(5, 1024, 1023, 2, torch.float32) == (8, 8, 5)
    assert GK.gram_grid(1, 1, 1, 1, torch.float64) == (1, 1, 1)
    for bad in [(1, 8, 8, 5), (1, 8, 8, 0), (65536, 8, 8, 2), (1, 65535 * 128 + 1, 8, 2),
                (1, 8, 2**31, 2)]:
        with pytest.raises(ValueError, match="outside the kernel's range"):
            GK.gram_grid(*bad, torch.float64)


@pytest.fixture
def stand_in_launch(monkeypatch):
    """The CUDA launchers on CPU tensors: the device checks, the device
    context and the stream are stood in for, and the C launch is recorded."""
    calls = []

    def launcher(prefix, dtype):
        def fn(*args):
            assert len(args) == len(_build._SIGNATURES[prefix])
            calls.append((prefix, args))
            return 0
        return fn

    monkeypatch.setattr(GK, "_check_cuda", lambda name, *t: None)
    monkeypatch.setattr(GK, "_launcher", launcher)
    monkeypatch.setattr(GK, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("shapes", [
    ((2,), (70000, 4, 2), (70000, 4, 2)),          # B above grid.z
    ((5,), (1, 4, 5), (1, 4, 5)),                  # D = 5
    ((2,), (1, 65535 * 128 + 1, 2), (1, 4, 2)),    # Na above grid.y
])
def test_gram_range_checks_raise_before_any_launch(stand_in_launch, shapes):
    l_shape, a_shape, b_shape = shapes
    l = torch.empty(a_shape[:1] + l_shape, device="meta", dtype=torch.float64)
    xa = torch.empty(a_shape, device="meta", dtype=torch.float64)
    xb = torch.empty(b_shape, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        GK.gram_cuda(l, xa, xb)
    assert stand_in_launch == []


@pytest.mark.parametrize("d,c,batch", [(5, 1, 1), (2, 3, 1), (2, 1, 65536)])
def test_predict_range_checks_raise_before_any_launch(stand_in_launch, d, c, batch):
    meta = dict(device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        GK.predict_mean_cuda(torch.empty(batch, d, **meta), torch.empty(batch, 8, d, **meta),
                             torch.empty(batch, 8, d, **meta), torch.empty(batch, 8, c, **meta))
    assert stand_in_launch == []


@pytest.mark.parametrize("batch,m,n,c", [(2, 10240, 1024, 1), (3, 1000, 20, 2)])
def test_predict_launch_passes_plan_and_scratch(stand_in_launch, batch, m, n, c):
    rng = np.random.default_rng(6)
    l = t64(rng.uniform(0.3, 2.0, size=(batch, 2)))
    xt, xtr = t64(cloud(rng, batch, m)), t64(cloud(rng, n)).expand(batch, n, 2)
    alpha = t64(rng.normal(size=(batch, c, n))).transpose(1, 2)  # strided, as passed
    out = GK.predict_mean_cuda(l, xt, xtr, alpha)
    (prefix, args), = stand_in_launch
    splits, chunk = GK.predict_plan(batch, m, n, 132)
    assert prefix == "rbf_predict_mean" and out.shape == (batch, m, c)
    assert args[4] == out.data_ptr()
    assert (args[5] is None) == (splits == 1)
    assert args[6:13] == (batch, m, n, 2, c, splits, chunk)
    assert args[13:24] == (*xt.stride(), 0, 2, 1, *l.stride(), *alpha.stride())


def test_gram_launch_passes_grid_operands(stand_in_launch):
    rng = np.random.default_rng(7)
    l = t64(rng.uniform(0.3, 2.0, size=(3, 2)))
    xa, xb = t64(cloud(rng, 3, 9)), t64(cloud(rng, 5)).expand(3, 5, 2)
    out = GK.gram_cuda(l, xa, xb)
    (prefix, args), = stand_in_launch
    assert prefix == "rbf_gram" and out.shape == (3, 9, 5) and out.is_contiguous()
    assert args[3:8] == (out.data_ptr(), 3, 9, 5, 2)
    assert args[8:16] == (*xa.stride(), 0, 2, 1, *l.stride())


def test_launches_are_counted_by_kernel_and_shape(stand_in_launch):
    GK.reset_launches()
    x = torch.zeros(3, 40, 2, dtype=torch.float64)
    l = torch.ones(3, 2, dtype=torch.float64)
    GK.gram_cuda(l, x, x[:, :8])
    GK.gram_cuda(l, x, x[:, :8])
    GK.predict_mean_cuda(l, x, x[:, :8], torch.zeros(3, 8, 2, dtype=torch.float64))
    assert GK.LAUNCHES == {"rbf_gram": 2, "rbf_predict_mean": 1, "rbf_gram_vjp": 0,
                           "rbf_predict_vjp": 0, "rbf_gram_vjp_points": 0}
    assert GK.LAUNCHES_BY_SHAPE == {("rbf_gram", (3, 40, 8, 2, "float64")): 2,
                                    ("rbf_predict_mean", (3, 40, 8, 2, 2, "float64")): 1}
    GK.reset_launches()
    assert set(GK.LAUNCHES.values()) == {0} and not GK.LAUNCHES_BY_SHAPE


def test_ctypes_signatures_match_the_c_prototypes():
    protos = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        protos.update(_build.c_prototypes(path))
    expected = {f"{prefix}_{s}": sig for prefix, sig in _build._SIGNATURES.items()
                for s in ("f32", "f64")}
    assert protos == expected


def test_bounds_at_main_path_shapes():
    """Bytes bound the variance gram (251.7 MB at 3.35 TB/s), FP64
    instructions the predict (exp plus 2D + 1 + C per triple at 17 G/ms)."""
    ms, by = KB.gram_bound(3, 10240, 1024, 2, 8)
    assert by == "bytes" and ms == pytest.approx((3 * 10240 * 1024 + 3 * 11264 * 2 + 6) * 8
                                                 / 3.35e9)
    ms, by = KB.predict_bound(3, 10240, 1024, 2, 2)
    per_triple = 2 * 2 + 1 + KB.EXP_F64_DP_INSTR + 2
    assert by == "operations" and ms == pytest.approx(3 * 10240 * 1024 * per_triple / 17e9)
    assert {c.per_step for c in KB.GRAM_CASES if c.dtype == torch.float64} == {0, 1}
    assert sum(c.per_step for c in KB.GRAM_CASES) == 3      # launches per step
    assert sum(c.per_tick for c in KB.GRAM_CASES) == 7      # ... per tick
    assert sum(c.per_tick for c in KB.PREDICT_CASES) == 4


def test_import_pulls_in_neither_jax_nor_gple_tpu():
    code = (
        "import sys, gple_tpu_torch, gple_tpu_torch.convert, gple_tpu_torch.entry, "
        "gple_tpu_torch.driver, gple_tpu_torch.parallel.sharding, "
        "gple_tpu_torch.ops._build, gple_tpu_torch.ops.kernel_bench, gple_tpu_torch.cli, "
        "gple_tpu_torch.config, gple_tpu_torch.observables, gple_tpu_torch.sampler.mc, "
        "gple_tpu_torch.sampler.keys, gple_tpu_torch.gp.opt, gple_tpu_torch.io.writers, "
        "gple_tpu_torch.oracles, gple_tpu_torch.validation, gple_tpu_torch.io.input_gen\n"
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


def _points(rng, *shape):
    """Points of a cloud as wide as the length scales, D = shape[-1]."""
    return 1.5 * rng.normal(size=shape) + 3.0


# (B, Na, Nb, D, xb broadcast over the batch)
GRAM_EDGES = [
    (5, 301, 203, 2, True),    # Nb odd: rows off 16 bytes; ragged rows and columns
    (3, 128, 64, 1, False),    # D = 1, whole tiles
    (2, 257, 130, 4, True),    # D = 4, one row past a block
    (1, 33, 1, 3, False),      # a single column
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
@pytest.mark.parametrize("batch,na,nb,d,bcast", GRAM_EDGES)
def test_gram_kernel_edges_and_repeats_on_gpu(cuda_device, dtype, tol, batch, na, nb, d,
                                              bcast):
    rng = np.random.default_rng(11)
    dev = cuda_device
    lengths = torch.tensor(rng.uniform(0.5, 3.0, size=(batch, d)), dtype=dtype, device=dev)
    xa = torch.tensor(_points(rng, batch, na, d), dtype=dtype, device=dev)
    xb = torch.tensor(_points(rng, 1 if bcast else batch, nb, d), dtype=dtype,
                      device=dev).expand(batch, nb, d)
    out, again = GK.gram_cuda(lengths, xa, xb), GK.gram_cuda(lengths, xa, xb)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert (out - GK.gram_plain(lengths, xa, xb)).abs().max().item() <= tol


# (B, M, N, D, C)
PREDICT_EDGES = [
    (3, 1000, 1000, 2, 2),    # M not a multiple of the row tile; N in uneven chunks
    (2, 256, 1500, 1, 1),     # D = 1; N above the chunk cap
    (1, 77, 2047, 4, 2),      # D = 4; many splits
    (2, 5000, 20, 3, 1),      # one split: N below the smallest chunk
]


@pytest.mark.gpu
@pytest.mark.parametrize("batch,m,n,d,c", PREDICT_EDGES)
def test_predict_kernel_edges_and_repeats_on_gpu(cuda_device, batch, m, n, d, c):
    rng = np.random.default_rng(12)
    dev, dt = cuda_device, torch.float64
    lengths = torch.tensor(rng.uniform(0.5, 3.0, size=(batch, d)), dtype=dt, device=dev)
    xt = torch.tensor(_points(rng, batch, m, d), dtype=dt, device=dev)
    xtr = torch.tensor(_points(rng, n, d), dtype=dt, device=dev).expand(batch, n, d)
    alpha = torch.tensor(rng.normal(size=(batch, c, n)), dtype=dt,
                         device=dev).transpose(1, 2)        # strided, like a stacked rhs
    out = GK.predict_mean_cuda(lengths, xt, xtr, alpha)
    again = GK.predict_mean_cuda(lengths, xt, xtr, alpha)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = GK.predict_mean_plain(lengths, xt, xtr, alpha)
    assert (out - ref).abs().max().item() <= 1e-10 * ref.abs().max().item()
