"""The ladder check on the CPU with the timed path broken underneath: a
whole run of a tiny reference-parity cell (:func:`tiny_root`) reads not
correct with the ladder broken in each of two ways (its gradient, its
loss), and with the tick broken in each of the ways of the other cells
(:mod:`test_bench_h100_control`)."""

import pytest
import torch

from bench_h100.test_bench_h100_control import (_altered_answer, _half_the_points,
                                                _unchanged_tick)
from bench_h100.test_bench_h100_ladder_check import run, tiny_root
from gple_tpu_torch.gp import opt as O


# -- planted faults of the ladder, as ``pytest.MonkeyPatch`` edits -------------------

def zero_length_axis(mp):
    """One axis of the lengths' cotangent zeroed in ``RBFGram.backward``."""
    from gple_tpu_torch.ops import gram_kernels as GK
    for name in ("gram_vjp_cuda", "gram_vjp_plain"):
        real = getattr(GK, name)

        def vjp(*args, real=real):
            out = real(*args).clone()
            out[..., 0] = 0.0
            return out
        mp.setattr(GK, name, vjp)


def float32_loss(mp):
    """The ladder's loss computed in float32 from its fits."""
    real = O._diag_loss_from_states

    def loss(states, data):
        f32 = lambda v: v.float() if torch.is_tensor(v) and v.is_floating_point() else v
        s32 = O.RK.RealTrainState(O.RK.KernelParams(*map(f32, states.params)),
                                  *map(f32, states[1:]))
        return real(s32, {k: f32(v) for k, v in data.items()}).double()
    mp.setattr(O, "_diag_loss_from_states", loss)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


#: the faults a run of the cell reads, each with a window that holds one of
#: its spans (a ladder without one gradient axis searches longer): the
#: ladder's gradient and loss, and the tick's state, its points and an
#: answer where it is produced
BROKEN = {"zero_length_axis": (zero_length_axis, 9.0), "float32_loss": (float32_loss, 5.0),
          "unchanged_tick": (_unchanged_tick, 5.0), "half_the_points": (_half_the_points, 5.0),
          "altered_answer": (_altered_answer, 5.0)}


@pytest.mark.parametrize("fault", list(BROKEN))
def test_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    plant, seconds = BROKEN[fault]
    plant(monkeypatch)
    res = run(root, seconds=seconds)
    assert not res["correct"], res["checks"]


