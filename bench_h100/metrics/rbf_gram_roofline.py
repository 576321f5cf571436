"""``rbf_gram_roofline``: ``rbf_gram``'s share of its roofline
(:func:`bench_h100.roofline.share`)."""

from bench_h100 import roofline


def read(ctx):
    return roofline.share(ctx, "rbf_gram")
