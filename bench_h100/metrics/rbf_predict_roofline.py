"""``rbf_predict_roofline``: ``rbf_predict_mean``'s share of its roofline
(:func:`bench_h100.roofline.share`)."""

from bench_h100 import roofline


def read(ctx):
    return roofline.share(ctx, "rbf_predict_mean")
