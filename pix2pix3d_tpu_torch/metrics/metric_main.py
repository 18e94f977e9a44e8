"""Metric registry and runner, port of `pix2pix3d_tpu/metrics/metric_main.py`
(ref `metrics/metric_main.py:29-68`): the same names in the same order.

    calc_metric("miou500", G=G, dataset=ds)             # on the card
    calc_metric("fid2k", G=G, dataset=ds, device="cpu")
    calc_metric("eq100", G=G_s3)                         # a GeneratorS3

The equivariance metrics (`eqt50k_int`, `eqt50k_frac`, `eqr50k`, `eq100`)
apply only to the StyleGAN3 generator (`nn/stylegan3.GeneratorS3`) and take
no dataset.
"""

from __future__ import annotations

import time

from . import metric_utils
from .equivariance import compute_equivariance_metrics
from .frechet_inception_distance import compute_fid
from .inception_score import compute_is
from .kernel_inception_distance import compute_kid
from .miou import compute_miou
from .perceptual_path_length import compute_ppl
from .precision_recall import compute_pr

_metric_dict = {}


def register_metric(fn):
    assert callable(fn)
    _metric_dict[fn.__name__] = fn
    return fn


def is_valid_metric(metric):
    return metric in _metric_dict


def list_valid_metrics():
    return list(_metric_dict.keys())


def calc_metric(metric, **kwargs):
    """Run `metric` with `MetricOptions(**kwargs)` (G, dataset, rng_seed,
    device...): {results, metric, total_time}."""
    assert is_valid_metric(metric), f"unknown metric {metric}"
    opts = metric_utils.MetricOptions(**kwargs)
    start = time.time()
    results = _metric_dict[metric](opts)
    return dict(results=results, metric=metric,
                total_time=time.time() - start)


@register_metric
def fid50k_full(opts):
    return {"fid50k_full": compute_fid(opts, max_real=None, num_gen=50000)}


@register_metric
def fid2k(opts):
    """Cheap FID for in-training eval."""
    return {"fid2k": compute_fid(opts, max_real=2000, num_gen=2000)}


@register_metric
def kid50k_full(opts):
    return {"kid50k_full": compute_kid(opts, max_real=1000000, num_gen=50000)}


@register_metric
def kid2k(opts):
    return {"kid2k": compute_kid(opts, max_real=2000, num_gen=2000)}


@register_metric
def pr50k3_full(opts):
    return compute_pr(opts, max_real=200000, num_gen=50000, nhood_size=3)


@register_metric
def pr2k(opts):
    return compute_pr(opts, max_real=2000, num_gen=2000, nhood_size=3)


@register_metric
def ppl2_wend(opts):
    return {"ppl2_wend": compute_ppl(opts, num_samples=50000)}


@register_metric
def ppl2_wend_small(opts):
    return {"ppl2_wend_small": compute_ppl(opts, num_samples=500)}


@register_metric
def is50k(opts):
    mean, std = compute_is(opts, num_gen=50000, num_splits=10)
    return {"is50k_mean": mean, "is50k_std": std}


@register_metric
def eqt50k_int(opts):
    r = compute_equivariance_metrics(opts, num_samples=50000, batch_size=4,
                                     compute_eqt_int=True)
    return {"eqt50k_int": r["eqt_int"]}


@register_metric
def eqt50k_frac(opts):
    r = compute_equivariance_metrics(opts, num_samples=50000, batch_size=4,
                                     compute_eqt_frac=True)
    return {"eqt50k_frac": r["eqt_frac"]}


@register_metric
def eqr50k(opts):
    r = compute_equivariance_metrics(opts, num_samples=50000, batch_size=4,
                                     compute_eqr=True)
    return {"eqr50k": r["eqr"]}


@register_metric
def eq100(opts):
    """Cheap all-three equivariance eval for smoke testing / training."""
    return compute_equivariance_metrics(
        opts, num_samples=100, batch_size=4, compute_eqt_int=True,
        compute_eqt_frac=True, compute_eqr=True)


@register_metric
def miou500(opts):
    return compute_miou(opts, num_items=500)


@register_metric
def miou2k(opts):
    return compute_miou(opts, num_items=2000)
