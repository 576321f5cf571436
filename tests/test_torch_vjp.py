"""PyTorch port: gradients through the kernel wrappers (``gram_kernels.RBFGram``,
``RBFPredictMean``) and the plain versions of their backward kernels.

``torch.autograd.gradcheck`` holds both Functions on the CPU route (float64,
its default tolerances: atol 1e-5, rtol 1e-3 against central differences);
each plain VJP is held against autograd of the plain forward to 1e-12
relative to its largest entry; a predict's gradient with respect to its
points raises, and so does a tensor that requires grad at a raw launcher.
The gradient of a fit's loss through the entry points agrees with
``jax.grad`` of the JAX package's on the same inputs to 1e-9 relative.  The
``gpu`` tests hold the three CUDA backward kernels against their plain
versions (1e-10 relative to the largest |entry|) and check that a backward
on the card launches them.  (The Gram's points cotangent is tested against
JAX in ``test_torch_full_ard.py``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gple_tpu.ops import kernels as JRK
from gple_tpu_torch.ops import gram_kernels as GK
from gple_tpu_torch.ops import kernels as RK
from test_torch_kernels import _warm_torch_exp, cloud, cuda_device  # noqa: F401 (fixtures)
from test_torch_kernels import one_torch_thread  # noqa: F401 (fixture)


TOL_VJP = 1e-12


def t64(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(21)
    return dict(lengths=rng.uniform(0.3, 2.0, size=(3, 2)), xa=cloud(rng, 3, 9),
                xb=cloud(rng, 3, 6), alpha=rng.normal(size=(3, 6, 2)),
                g_gram=rng.normal(size=(3, 9, 6)), g_pred=rng.normal(size=(3, 9, 2)))


def test_gradcheck_rbf_gram(operands):
    args = (t64(operands["lengths"], True), t64(operands["xa"]), t64(operands["xb"]))
    assert torch.autograd.gradcheck(GK.RBFGram.apply, args)


def test_gradcheck_rbf_predict_mean(operands):
    args = (t64(operands["lengths"], True), t64(operands["xa"]), t64(operands["xb"]),
            t64(operands["alpha"], True))
    assert torch.autograd.gradcheck(GK.RBFPredictMean.apply, args)


def _rel(ours, theirs):
    return (ours - theirs).abs().max().item() / theirs.abs().max().item()


def test_gram_vjp_plain_matches_autograd(operands):
    l = t64(operands["lengths"], True)
    xa, xb, g = t64(operands["xa"]), t64(operands["xb"]), t64(operands["g_gram"])
    (ref,) = torch.autograd.grad(GK.gram_plain(l, xa, xb), l, g)
    assert _rel(GK.gram_vjp_plain(l.detach(), xa, xb, g), ref) <= TOL_VJP


def test_predict_vjp_plain_matches_autograd(operands):
    l, alpha = t64(operands["lengths"], True), t64(operands["alpha"])
    xa, xb, g = t64(operands["xa"]), t64(operands["xb"]), t64(operands["g_pred"])
    (ref,) = torch.autograd.grad(GK.predict_mean_plain(l, xa, xb, alpha), l, g)
    assert _rel(GK.predict_vjp_plain(l.detach(), xa, xb, alpha, g), ref) <= TOL_VJP


def test_entry_points_reduce_broadcast_lengths(operands):
    """Lengths broadcast over a batch of point sets get the summed cotangent."""
    l = t64(operands["lengths"][0], True)
    xa, xb = t64(operands["xa"]), t64(operands["xb"])
    GK.gram_rbf(l, xa, xb).square().sum().backward()
    ref = t64(operands["lengths"][0], True)
    GK.gram_plain(ref, xa, xb).square().sum().backward()
    assert l.grad.shape == (2,) and _rel(l.grad, ref.grad) <= TOL_VJP


@pytest.mark.parametrize("which", ["predict"])
def test_points_gradient_raises(operands, which):
    l, xa, xb = t64(operands["lengths"], True), t64(operands["xa"], True), t64(operands["xb"])
    out = GK.predict_mean_rbf(l, xa, xb, t64(operands["alpha"]))
    with pytest.raises(NotImplementedError, match="points"):
        out.sum().backward()


def test_matrix_lengths_gradient_reaches_the_points_cotangent(operands):
    """Full-ARD matrix lengths reach the kernel as transformed points z = W x:
    the gradient of W runs through ``RBFGram``'s points cotangent and equals
    autograd of the plain formula."""
    w = t64([[2.0, 0.0], [0.3, 0.5]], True)
    x = t64(operands["xa"][0])
    RK.gram(w, x, x).square().sum().backward()
    ref = t64([[2.0, 0.0], [0.3, 0.5]], True)
    z = x @ ref.T
    GK.gram_plain(torch.ones(2, dtype=torch.float64), z, z).square().sum().backward()
    assert _rel(w.grad, ref.grad) <= TOL_VJP


@pytest.mark.parametrize("launcher", ["gram", "predict", "gram_vjp", "predict_vjp",
                                      "gram_vjp_points"])
def test_raw_launchers_refuse_tensors_that_require_grad(launcher):
    """The check comes before the device check: it holds for any tensor."""
    l = torch.ones(1, 2, dtype=torch.float64, requires_grad=True)
    x = torch.zeros(1, 4, 2, dtype=torch.float64)
    a = torch.zeros(1, 4, 1, dtype=torch.float64)
    calls = {"gram": lambda: GK.gram_cuda(l, x, x),
             "predict": lambda: GK.predict_mean_cuda(l, x, x, a),
             "gram_vjp": lambda: GK.gram_vjp_cuda(l, x, x, torch.zeros(1, 4, 4, dtype=torch.float64)),
             "predict_vjp": lambda: GK.predict_vjp_cuda(l, x, x, a, a),
             "gram_vjp_points": lambda: GK.gram_vjp_points_cuda(
                 l, x, x, torch.zeros(1, 4, 4, dtype=torch.float64))}
    with pytest.raises(RuntimeError, match="requires grad"):
        calls[launcher]()
    with torch.no_grad(), pytest.raises(ValueError, match="expected CUDA"):
        calls[launcher]()


def test_fit_loss_gradient_matches_jax_grad(operands):
    """d/dl of LOOCV + extra-set error of a two-element fit: port autograd
    (RBFGram, RBFPredictMean, the Cholesky) against ``jax.grad``."""
    rng = np.random.default_rng(22)
    pts, epts = cloud(rng, 2, 24), cloud(rng, 2, 60)
    amp = np.exp(-0.5 * np.sum(((pts - [-10.0, 30.0]) / [1 / 3, 1.5]) ** 2, axis=-1))
    eamp = np.exp(-0.5 * np.sum(((epts - [-10.0, 30.0]) / [1 / 3, 1.5]) ** 2, axis=-1))
    lengths = np.array([[0.3, 1.4], [0.5, 1.1]])

    def jloss(l):
        p = JRK.KernelParams(magnitude=jnp.ones(2), lengths=l, noise=jnp.full(2, 1e-2))
        st = jax.vmap(JRK.fit_real)(p, jnp.asarray(pts), jnp.asarray(amp))
        return jnp.sum(jax.vmap(JRK.loocv_error)(st) + jax.vmap(JRK.extra_set_error)(
            st, jnp.asarray(epts), jnp.asarray(eamp)))

    l = t64(lengths, True)
    p = RK.KernelParams(magnitude=torch.ones(2, dtype=torch.float64), lengths=l,
                        noise=torch.full((2,), 1e-2, dtype=torch.float64))
    st = RK.fit_real(p, t64(pts), t64(amp))
    loss = torch.sum(RK.loocv_error(st) + RK.extra_set_error(st, t64(epts), t64(eamp)))
    loss.backward()
    ref = np.asarray(jax.grad(jloss)(jnp.asarray(lengths)))
    np.testing.assert_allclose(loss.item(), float(jloss(jnp.asarray(lengths))), rtol=1e-10)
    np.testing.assert_allclose(l.grad.numpy(), ref, rtol=1e-9, atol=1e-9 * np.abs(ref).max())


# -- the CUDA VJP kernels on the card ------------------------------------------------

VJP_SHAPES = [(2, 300, 200, 2, 0), (3, 257, 130, 4, 1), (1, 77, 2047, 1, 2), (2, 33, 1, 3, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("batch,na,nb,d,c", VJP_SHAPES)
def test_vjp_kernels_match_plain_on_gpu(cuda_device, batch, na, nb, d, c):
    rng = np.random.default_rng(23)
    dev, dt = cuda_device, torch.float64
    l = torch.tensor(rng.uniform(0.5, 3.0, size=(batch, d)), dtype=dt, device=dev)
    xa = torch.tensor(1.5 * rng.normal(size=(batch, na, d)), dtype=dt, device=dev)
    xb = torch.tensor(1.5 * rng.normal(size=(nb, d)), dtype=dt, device=dev).expand(batch, nb, d)
    if c == 0:
        g = torch.tensor(rng.normal(size=(batch, na, nb)), dtype=dt, device=dev)
        out, again = GK.gram_vjp_cuda(l, xa, xb, g), GK.gram_vjp_cuda(l, xa, xb, g)
        ref = GK.gram_vjp_plain(l, xa, xb, g)
    else:
        alpha = torch.tensor(rng.normal(size=(batch, c, nb)), dtype=dt,
                             device=dev).transpose(1, 2)
        g = torch.tensor(rng.normal(size=(batch, na, c)), dtype=dt, device=dev)
        out = GK.predict_vjp_cuda(l, xa, xb, alpha, g)
        again = GK.predict_vjp_cuda(l, xa, xb, alpha, g)
        ref = GK.predict_vjp_plain(l, xa, xb, alpha, g)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert _rel(out, ref) <= 1e-10


@pytest.mark.gpu
def test_backward_on_gpu_launches_the_vjp_kernels(cuda_device):
    rng = np.random.default_rng(24)
    dev = cuda_device
    l = torch.tensor(rng.uniform(0.5, 2.0, size=(2, 2)), device=dev, requires_grad=True)
    x = torch.tensor(cloud(rng, 2, 300), device=dev)
    alpha = torch.tensor(rng.normal(size=(2, 300, 1)), device=dev, requires_grad=True)
    xg = x.clone().requires_grad_(True)
    GK.reset_launches()
    loss = (GK.predict_mean_rbf(l, x[:, :100], x, alpha).square().sum()
            + GK.gram_rbf(l, x, xg).square().sum())
    loss.backward()
    torch.cuda.synchronize()
    assert GK.LAUNCHES == {"rbf_gram": 1, "rbf_predict_mean": 2, "rbf_gram_vjp": 1,
                           "rbf_predict_vjp": 1, "rbf_gram_vjp_points": 1}
    ref = x.clone().requires_grad_(True)
    GK.gram_plain(l.detach(), x, ref).square().sum().backward()
    assert _rel(xg.grad, ref.grad) <= 1e-10


# (B, Na, Nb, D, xb broadcast, cotangent read transposed)
POINTS_SHAPES = [(1, 200, 200, 2, False, False), (7, 200, 200, 2, True, True),
                 (3, 301, 203, 4, True, True), (2, 33, 1, 3, False, False),
                 (2, 9, 700, 1, True, False), (1, 1024, 1024, 2, False, False),
                 (1, 160, 160, 2, False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("sides", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("batch,na,nb,d,bcast,trans", POINTS_SHAPES)
def test_points_kernel_matches_plain_on_gpu(cuda_device, batch, na, nb, d, bcast, trans,
                                            sides):
    """The pair call, both sides or either alone, against the pair's plain
    counterpart; two calls bit for bit."""
    rng = np.random.default_rng(26)
    dev, dt = cuda_device, torch.float64
    l = torch.tensor(rng.uniform(0.5, 3.0, size=(batch, d)), dtype=dt, device=dev)
    xa = torch.tensor(1.5 * rng.normal(size=(batch, na, d)), dtype=dt, device=dev)
    xb = torch.tensor(1.5 * rng.normal(size=(1 if bcast else batch, nb, d)), dtype=dt,
                      device=dev).expand(batch, nb, d)
    g = (torch.tensor(rng.normal(size=(batch, nb, na)), dtype=dt, device=dev).transpose(1, 2)
         if trans else torch.tensor(rng.normal(size=(batch, na, nb)), dtype=dt, device=dev))
    out = GK.gram_vjp_points_cuda(l, xa, xb, g, *sides)
    again = GK.gram_vjp_points_cuda(l, xa, xb, g, *sides)
    ref = GK.gram_vjp_points_pair_plain(l, xa, xb, g, *sides)
    torch.cuda.synchronize()
    for o, a, r, want in zip(out, again, ref, sides):
        assert (o is not None) == want and (r is not None) == want
        if want:
            assert torch.equal(o, a)
            assert _rel(o, r) <= 1e-10


# -- bounds and shapes of the VJP kernels (gple_tpu_torch.ops.kernel_bench) -------------

def test_vjp_bounds_at_ladder_shapes():
    """Bytes bound the dense Gram cotangent (8 bytes against 24 FP64
    instructions a pair), FP64 instructions the rank-C predict weight; the
    points cotangent's pair call (one distance and one exp a pair, D
    multiply-adds for each side: 4D + 17, 25 against its cotangent's 8
    bytes) by its bytes."""
    from gple_tpu_torch.ops import kernel_bench as KB

    assert KB.points_vjp_dp_per_pair(2) == 4 * 2 + 2 + KB.EXP_F64_DP_INSTR == 25
    for n in (200, 160, 1024):
        ms, by = KB.gram_vjp_points_bound(1, n, n, 2)
        assert by == "bytes" and ms == pytest.approx((n * n + 2 * 2 * n * 2 + 2) * 8 / 3.35e9)
        assert n * n * 25 / 17e9 < ms
    ms, by = KB.gram_vjp_points_bound(1, 200, 200, 2, itemsize=4)
    assert by == "bytes" and ms == pytest.approx((200 * 200 + 2 * 400 * 2 + 2) * 4 / 3.35e9)
    assert [c.na for c in KB.POINTS_VJP_CASES] == [200, 160, 1024]

    assert KB.vjp_dp_per_pair(2) == 4 * 2 + 1 + KB.EXP_F64_DP_INSTR == 24
    assert KB.vjp_dp_per_pair(2, 2) == 26
    ms, by = KB.gram_vjp_bound(2, 1024, 1024, 2)
    assert by == "bytes" and ms == pytest.approx((2 * 1024 * 1024 + 2 * 2048 * 2 + 8) * 8
                                                 / 3.35e9)
    ms, by = KB.predict_vjp_bound(3, 5120, 1024, 2, 2)
    assert by == "operations" and ms == pytest.approx(3 * 5120 * 1024 * 26 / 17e9)
    assert {c.kernel for c in KB.VJP_CASES} == {"rbf_gram_vjp", "rbf_predict_vjp"}
    assert all(c.key[0] == c.kernel for c in KB.VJP_CASES)


def test_launched_vjp_shapes_become_cases():
    from gple_tpu_torch.ops import kernel_bench as KB

    keys = {("rbf_gram_vjp", (7, 100, 50, 2, "float64")),
            ("rbf_predict_vjp", (2, 300, 40, 1, 2, "float64")),
            ("rbf_gram_vjp_points", (1, 200, 200, 2, "float64")),
            KB.VJP_CASES[0].key, ("rbf_gram", (4, 8, 8, 2, "float64"))}
    grams, predicts, vjps = KB.cases_from_launches(keys, "test", known={("rbf_gram", (
        4, 8, 8, 2, "float64"))})
    assert grams == () and predicts == ()
    assert sorted(c.key for c in vjps) == sorted(keys - {KB.VJP_CASES[0].key,
                                                         ("rbf_gram", (4, 8, 8, 2, "float64"))})


def test_vjp_launchers_pass_strides_and_scratch(monkeypatch):
    """The VJP launchers on CPU tensors with a stand-in for the C launch: the
    argument order of the C prototypes, strided and broadcast operands read
    in place (a transposed Gram cotangent as its transpose, the point sets
    swapped), a scratch of the plan's partials and the device's counter,
    counted launches under the caller's shape."""
    import contextlib
    import types

    from gple_tpu_torch.ops import _build

    calls, scratches = [], []

    def launcher(prefix, dtype):
        def fn(*args):
            assert len(args) == len(_build._SIGNATURES[prefix])
            calls.append((prefix, args))
            return 0
        return fn

    def vjp_scratch(plan, d, like):
        scratches.append((plan, d, GK.vjp_scratch.__wrapped__(plan, d, like)))
        return scratches[-1][2]

    vjp_scratch.__wrapped__ = GK.vjp_scratch
    monkeypatch.setattr(GK, "_check_cuda", lambda name, *t: None)
    monkeypatch.setattr(GK, "_launcher", launcher)
    monkeypatch.setattr(GK, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(GK, "vjp_scratch", vjp_scratch)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    GK.reset_launches()
    rng = np.random.default_rng(25)
    l = t64(rng.uniform(0.3, 2.0, size=(3, 2)))
    xa, xb = t64(cloud(rng, 3, 70)), t64(cloud(rng, 40)).expand(3, 40, 2)
    g = t64(rng.normal(size=(3, 40, 70))).transpose(1, 2)
    out = GK.gram_vjp_cuda(l, xa, xb, g)
    (prefix, args), = calls
    plan, d, scratch = scratches[0]
    assert prefix == "rbf_gram_vjp" and out.shape == (3, 2)
    assert args[:4] == (xb.data_ptr(), xa.data_ptr(), l.data_ptr(), g.data_ptr())
    assert args[5] == scratch.data_ptr() and args[6] == GK._TICKETS[l.device].data_ptr()
    assert plan == GK.vjp_plan(3, 40, 70, 132) and d == 2
    assert scratch.numel() == 3 * plan.row_blocks * plan.col_tiles * 2
    assert args[7:13] == (3, 40, 70, 2, plan.rows, 1)
    assert args[13:24] == (0, 2, 1, *xa.stride(), *l.stride(), 2800, 70, 1)
    assert GK.LAUNCHES_BY_SHAPE == {("rbf_gram_vjp", (3, 70, 40, 2, "float64")): 1}
    assert GK.GRAM_VJP_READS == {"transposed, 16-byte copies": 1}
    alpha = t64(rng.normal(size=(3, 2, 40))).transpose(1, 2)
    gp = t64(rng.normal(size=(3, 70, 2)))
    GK.predict_vjp_cuda(l, xa, xb, alpha, gp)
    prefix, args = calls[1]
    plan, d, scratch = scratches[1]
    assert prefix == "rbf_predict_vjp" and plan == GK.vjp_plan(3, 70, 40, 132)
    assert args[6] == scratch.data_ptr() and args[7] == GK._TICKETS[l.device].data_ptr()
    assert args[8:14] == (3, 70, 40, 2, 2, plan.rows)
    assert args[14:28] == (*xa.stride(), 0, 2, 1, *l.stride(), *gp.stride(), *alpha.stride())
    d_xa, d_xb = GK.gram_vjp_points_cuda(l, xa, xb, g, True, True)
    prefix, args = calls[2]
    plan = GK.points_plan(3, 70, 40, True, True, 132)
    assert prefix == "rbf_gram_vjp_points"
    assert d_xa.shape == (3, 70, 2) and d_xb.shape == (3, 40, 2)
    assert args[:6] == (xa.data_ptr(), xb.data_ptr(), l.data_ptr(), g.data_ptr(),
                        d_xa.data_ptr(), d_xb.data_ptr())
    assert args[6:11] == (3, 70, 40, 2, plan.own)
    assert args[11:22] == (*xa.stride(), 0, 2, 1, *l.stride(), *g.stride())
    # one side asked: a null pointer for the other, the same count
    d_xa, d_xb = GK.gram_vjp_points_cuda(l, xa, xb, g, False, True)
    prefix, args = calls[3]
    assert d_xa is None and args[4] is None and args[5] == d_xb.data_ptr()
    assert args[10] == GK.points_plan(3, 70, 40, False, True, 132).own
    assert GK.LAUNCHES["rbf_gram_vjp"] == GK.LAUNCHES["rbf_predict_vjp"] == 1
    assert GK.LAUNCHES["rbf_gram_vjp_points"] == 2
    assert GK.LAUNCHES_BY_SHAPE[("rbf_gram_vjp_points", (3, 70, 40, 2, "float64"))] == 2
    assert GK.POINTS_VJP_READS == {((2800, 1, 70), "ab"): 1, ((2800, 1, 70), "b"): 1}
    GK.reset_launches()
    GK._TICKETS.pop(l.device)


def test_gram_backward_makes_one_points_call(monkeypatch):
    """A Gram's backward with both point sets requiring grad is one
    ``rbf_gram_vjp_points`` call (a stand-in for the C launch, on CPU
    tensors routed as if on the card) with both output pointers; with one
    set, one call with a null pointer for the other."""
    import contextlib
    import types

    from gple_tpu_torch.ops import _build

    calls = []

    def launcher(prefix, dtype):
        def fn(*args):
            assert len(args) == len(_build._SIGNATURES[prefix])
            calls.append((prefix, args))
            return 0
        return fn

    monkeypatch.setattr(GK, "_check_cuda", lambda name, *t: None)
    monkeypatch.setattr(GK, "_launcher", launcher)
    monkeypatch.setattr(GK, "_route", lambda name, t: True)
    monkeypatch.setattr(GK, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    GK.reset_launches()
    rng = np.random.default_rng(27)
    l = t64(rng.uniform(0.3, 2.0, size=(2, 2)))
    for want_a, want_b in ((True, True), (False, True), (True, False)):
        xa, xb = t64(cloud(rng, 2, 9), want_a), t64(cloud(rng, 2, 5), want_b)
        calls.clear()
        GK.RBFGram.apply(l, xa, xb).backward(t64(rng.normal(size=(2, 9, 5))))
        points = [args for prefix, args in calls if prefix == "rbf_gram_vjp_points"]
        assert [prefix for prefix, _ in calls] == ["rbf_gram", "rbf_gram_vjp_points"]
        (args,) = points
        assert (args[4] is not None, args[5] is not None) == (want_a, want_b)
        assert args[6:10] == (2, 9, 5, 2)
        assert (xa.grad is not None, xb.grad is not None) == (want_a, want_b)
    assert GK.LAUNCHES["rbf_gram_vjp_points"] == 3 and GK.LAUNCHES["rbf_gram_vjp"] == 0
    GK.reset_launches()


# -- the length-cotangent kernel's launch plan (gram_kernels.vjp_plan) ------------------

#: (B, Na, Nb): the ladder's shapes at N = 1024, validation's NLL shapes and
#: ragged ones (Na, Nb not multiples of a block's rows or columns)
PLAN_SHAPES = [(2, 1024, 1024), (3, 1024, 1024), (5, 1024, 1024), (2, 5120, 1024),
               (3, 5120, 1024), (1, 150, 150), (1, 160, 160), (1, 200, 200), (7, 200, 200),
               (1, 1, 1), (2, 33, 1), (3, 257, 130), (1, 77, 2047), (4, 1000, 999),
               (5, 300, 7), (2, 1024, 5120), (1, 100_003, 3)]


@pytest.mark.parametrize("batch,na,nb", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 16])
def test_vjp_plan_covers_every_pair_once(batch, na, nb, sms):
    """The grid's blocks, as the kernel maps them (block (x, y, b): rows
    [y * rows, min((y + 1) * rows, Na)), columns [x * 256, min((x + 1) * 256,
    Nb))), take every (i, j) pair of every batch entry exactly once, and no
    block is empty."""
    plan = GK.vjp_plan(batch, na, nb, sms)
    cols = GK.VJP_COLS_PER_BLOCK
    assert plan.grid == (plan.col_tiles, plan.row_blocks, batch)
    rows_hit = np.zeros(na, dtype=int)
    for y in range(plan.row_blocks):
        lo, hi = y * plan.rows, min((y + 1) * plan.rows, na)
        assert hi > lo
        rows_hit[lo:hi] += 1
    cols_hit = np.zeros(nb, dtype=int)
    for x in range(plan.col_tiles):
        lo, hi = x * cols, min((x + 1) * cols, nb)
        assert hi > lo
        cols_hit[lo:hi] += 1
    assert np.all(rows_hit == 1) and np.all(cols_hit == 1)


@pytest.mark.parametrize("batch,na,nb", PLAN_SHAPES)
def test_vjp_plan_grid_and_scratch(batch, na, nb):
    """The grid stays inside CUDA's limits (x < 2^31, y and z <= 65535, rows
    within the kernel's shared-memory tile), the plan fills a 132-SM card at
    the ladder's shapes, and the scratch holds the largest partial index the
    kernel writes, (b * parts + y * grid.x + x) * D + d, for D = 1-4."""
    plan = GK.vjp_plan(batch, na, nb, 132)
    gx, gy, gz = plan.grid
    assert 1 <= plan.rows <= GK.VJP_MAX_ROWS and 1 <= gx < 2**31
    assert 1 <= gy <= 65535 and 1 <= gz <= 65535 and gx * gy * gz < 2**31
    if na * nb * batch >= 1024 * 1024:
        assert gx * gy * gz >= 132
    for d in range(1, GK.MAX_DIM + 1):
        last = ((gz - 1) * gx * gy + (gy - 1) * gx + (gx - 1)) * d + (d - 1)
        assert plan.scratch_size(d) == last + 1


def test_vjp_plan_refuses_grids_outside_cudas_limits():
    plan = GK.vjp_plan(1, GK.VJP_MAX_ROWS * 65535, 2, 132)
    assert plan.row_blocks == 65535
    with pytest.raises(ValueError, match="grid"):
        GK.vjp_plan(1, GK.VJP_MAX_ROWS * 65535 + 1, 2, 132)
    with pytest.raises(ValueError, match="grid"):
        GK.vjp_plan(65536, 8, 8, 132)


# -- the points cotangent's launch plan (gram_kernels.points_plan) ----------------------

#: sides asked: both, xa's alone, xb's alone
POINT_SIDES = [(True, True), (True, False), (False, True)]


def _points_pairs_hit(plan, na, nb, want_a, want_b):
    """Pairs (i, j) each side's blocks take, as the kernel maps them: block x
    < tiles_a takes rows [x * own, min((x + 1) * own, Na)) of G, a later one
    columns; each own point's threads p = 0 .. per - 1 take the summed
    axis's points p, p + per, ... of every POINTS_CHUNK chunk."""
    per = GK.POINTS_THREADS // plan.own
    hits = {}
    for side, n_own, n_sum, tiles in (("a", na, nb, plan.tiles_a), ("b", nb, na, plan.tiles_b)):
        ks = np.concatenate([k0 + np.arange(p, min(GK.POINTS_CHUNK, n_sum - k0), per)
                             for k0 in range(0, n_sum, GK.POINTS_CHUNK) for p in range(per)])
        count = np.zeros((n_own, n_sum), dtype=np.int64)
        for x in range(tiles):
            lo, hi = x * plan.own, min((x + 1) * plan.own, n_own)
            assert hi > lo
            np.add.at(count, (slice(lo, hi), ks), 1)
        hits[side] = count
    return hits


@pytest.mark.parametrize("want_a,want_b", POINT_SIDES)
@pytest.mark.parametrize("batch,na,nb", [s for s in PLAN_SHAPES if s[1] < 10**5])
@pytest.mark.parametrize("sms", [132, 16])
def test_points_plan_covers_every_pair_once(batch, na, nb, sms, want_a, want_b):
    """Every (i, j) pair of each side asked is taken exactly once, a side not
    asked has no block, and no block is empty."""
    plan = GK.points_plan(batch, na, nb, want_a, want_b, sms)
    assert plan.grid == (plan.tiles_a + plan.tiles_b, batch)
    hits = _points_pairs_hit(plan, na, nb, want_a, want_b)
    for side, want in (("a", want_a), ("b", want_b)):
        assert np.all(hits[side] == (1 if want else 0))


@pytest.mark.parametrize("want_a,want_b", POINT_SIDES)
@pytest.mark.parametrize("batch,na,nb", PLAN_SHAPES)
def test_points_plan_grid_and_shared_memory(batch, na, nb, want_a, want_b):
    """The grid stays inside CUDA's limits (x < 2^31, y <= 65535), own points
    a block are a power of two the kernel takes (at least one 32-byte sector
    of doubles for xb's side), the dynamic shared memory fits the 48 KB a
    block has without opting in, for D = 1-4, and validation's B = 1 shapes
    put every SM to work."""
    plan = GK.points_plan(batch, na, nb, want_a, want_b, 132)
    gx, gy = plan.grid
    assert 1 <= gx < 2**31 and gy == batch <= 65535
    assert plan.own in (4, 8, 16) and plan.own <= GK.POINTS_MAX_OWN
    for d in range(1, GK.MAX_DIM + 1):
        smem = 8 * (plan.own * (GK.POINTS_CHUNK + 1) + d * GK.POINTS_CHUNK
                    + GK.POINTS_THREADS // 32 * d)
        assert smem <= 48 * 1024
    if (batch, na, nb) == (1, 200, 200) and want_a and want_b:
        assert plan == GK.PointsPlan(4, 50, 50, 1)


def test_points_plan_refuses_grids_outside_cudas_limits():
    with pytest.raises(ValueError, match="grid"):
        GK.points_plan(65536, 8, 8, True, True, 132)
    with pytest.raises(ValueError, match="grid"):
        GK.points_plan(1, 8, 8, False, False, 132)


@pytest.mark.parametrize("strides,read_a,read_b", [
    ((2800, 70, 1), "along the summed axis, contiguous", "along the own points, runs of own"),
    ((2800, 1, 40), "along the own points, runs of own", "along the summed axis, contiguous"),
    ((0, 71, 1), "along the summed axis, contiguous", "along the own points, runs of own"),
    ((2800, 140, 2), "strided", "strided")])
def test_points_vjp_read_names_the_branch(strides, read_a, read_b):
    assert GK.points_vjp_read(strides, "a") == read_a
    assert GK.points_vjp_read(strides, "b") == read_b


def test_gram_vjp_read_picks_the_kernels_branch():
    """16-byte copies where the cotangent (or its transpose) is contiguous
    along its rows with even strides and an aligned pointer; the strided
    branch otherwise."""
    g = torch.zeros(3, 40, 70, dtype=torch.float64)
    assert GK.gram_vjp_read(g) == (False, True)
    assert GK.gram_vjp_read(g.transpose(1, 2)) == (True, True)
    assert GK.gram_vjp_read(g[:1].expand(3, 40, 70)) == (False, True)
    assert GK.gram_vjp_read(torch.zeros(3, 40, 71, dtype=torch.float64)) == (False, False)
    assert GK.gram_vjp_read(g[:, :, 1:69]) == (False, False)   # 8 bytes off
    assert GK.gram_vjp_read(g[:, :, ::2]) == (False, False)    # column stride 2
