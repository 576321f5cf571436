"""PyTorch port: gradients through the kernel wrappers (``gram_kernels.RBFGram``,
``RBFPredictMean``) and the plain versions of their backward kernels.

``torch.autograd.gradcheck`` holds both Functions on the CPU route (float64,
its default tolerances: atol 1e-5, rtol 1e-3 against central differences);
each plain VJP is held against autograd of the plain forward to 1e-12
relative to its largest entry; a gradient with respect to the points raises,
and so does a tensor that requires grad at a raw launcher.  The gradient of
a fit's loss through the entry points agrees with ``jax.grad`` of the JAX
package's on the same inputs to 1e-9 relative.  The ``gpu`` tests hold the
two CUDA VJP kernels against their plain versions (1e-10 relative to the
largest |entry|) and check that a backward on the card launches them.
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The ladder is thousands of small tensor ops; with one process per
    core (the suite's workers) intra-op threads only contend for the cores.
    One thread per process for this module; the previous count after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

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


@pytest.mark.parametrize("which", ["gram", "predict"])
def test_points_gradient_raises(operands, which):
    l, xa, xb = t64(operands["lengths"], True), t64(operands["xa"], True), t64(operands["xb"])
    out = (GK.gram_rbf(l, xa, xb) if which == "gram"
           else GK.predict_mean_rbf(l, xa, xb, t64(operands["alpha"])))
    with pytest.raises(NotImplementedError, match="item 12"):
        out.sum().backward()


def test_matrix_lengths_gradient_raises(operands):
    """Full-ARD matrix lengths reach the kernel as transformed points."""
    w = t64(np.diag([2.0, 0.5]), True)
    x = t64(operands["xa"][0])
    with pytest.raises(NotImplementedError, match="item 12"):
        RK.gram(w, x, x).sum().backward()


@pytest.mark.parametrize("launcher", ["gram", "predict", "gram_vjp", "predict_vjp"])
def test_raw_launchers_refuse_tensors_that_require_grad(launcher):
    """The check comes before the device check: it holds for any tensor."""
    l = torch.ones(1, 2, dtype=torch.float64, requires_grad=True)
    x = torch.zeros(1, 4, 2, dtype=torch.float64)
    a = torch.zeros(1, 4, 1, dtype=torch.float64)
    calls = {"gram": lambda: GK.gram_cuda(l, x, x),
             "predict": lambda: GK.predict_mean_cuda(l, x, x, a),
             "gram_vjp": lambda: GK.gram_vjp_cuda(l, x, x, torch.zeros(1, 4, 4, dtype=torch.float64)),
             "predict_vjp": lambda: GK.predict_vjp_cuda(l, x, x, a, a)}
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
    GK.reset_launches()
    loss = (GK.predict_mean_rbf(l, x[:, :100], x, alpha).square().sum()
            + GK.gram_rbf(l, x, x).square().sum())
    loss.backward()
    torch.cuda.synchronize()
    assert GK.LAUNCHES == {"rbf_gram": 1, "rbf_predict_mean": 2, "rbf_gram_vjp": 1,
                           "rbf_predict_vjp": 1}


# -- bounds and shapes of the VJP kernels (gple_tpu_torch.ops.kernel_bench) -------------

def test_vjp_bounds_at_ladder_shapes():
    """Bytes bound the dense Gram cotangent (8 bytes against 24 FP64
    instructions a pair), FP64 instructions the rank-C predict weight."""
    from gple_tpu_torch.ops import kernel_bench as KB

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
            KB.VJP_CASES[0].key, ("rbf_gram", (4, 8, 8, 2, "float64"))}
    grams, predicts, vjps = KB.cases_from_launches(keys, "test", known={("rbf_gram", (
        4, 8, 8, 2, "float64"))})
    assert grams == () and predicts == ()
    assert sorted(c.key for c in vjps) == sorted(keys - {KB.VJP_CASES[0].key,
                                                         ("rbf_gram", (4, 8, 8, 2, "float64"))})


def test_vjp_launchers_pass_strides_and_scratch(monkeypatch):
    """The VJP launchers on CPU tensors with a stand-in for the C launch: the
    argument order of the C prototypes, strided and broadcast operands read
    in place, a scratch of ``vjp_partials`` partials, counted launches."""
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
    assert prefix == "rbf_gram_vjp" and out.shape == (3, 2)
    assert args[6:10] == (3, 70, 40, 2)
    assert args[10:21] == (*xa.stride(), 0, 2, 1, *l.stride(), *g.stride())
    alpha = t64(rng.normal(size=(3, 2, 40))).transpose(1, 2)
    gp = t64(rng.normal(size=(3, 70, 2)))
    GK.predict_vjp_cuda(l, xa, xb, alpha, gp)
    prefix, args = calls[1]
    assert prefix == "rbf_predict_vjp" and args[7:12] == (3, 70, 40, 2, 2)
    assert args[12:26] == (*xa.stride(), 0, 2, 1, *l.stride(), *gp.stride(), *alpha.stride())
    assert GK.vjp_partials(70, 40) == 1 * 3
    assert GK.LAUNCHES["rbf_gram_vjp"] == GK.LAUNCHES["rbf_predict_vjp"] == 1
    GK.reset_launches()
