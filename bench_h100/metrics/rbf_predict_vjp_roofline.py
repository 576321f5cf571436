"""``rbf_predict_vjp_roofline``: ``rbf_predict_vjp``'s share of its roofline
(:func:`bench_h100.roofline.share`): the extra-set prediction's length
cotangent of the ladder's gradients."""

from bench_h100 import roofline


def read(ctx):
    return roofline.share(ctx, "rbf_predict_vjp")
