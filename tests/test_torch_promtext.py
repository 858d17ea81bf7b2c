"""The port's ``utils/promtext.py`` against the JAX package's: the same
metrics dicts render byte-identical Prometheus text, ``lint_exposition``
gives the same violations over a corpus holding every bad case of
``tests/test_promlint.py``, and the same observations give equal
``LatencyHistogram`` snapshots, ``add_histograms`` sums and
``histogram_quantile`` values (exact: the same float arithmetic).
"""
import numpy as np
import pytest

from pytorch_distributed_template_tpu.utils import promtext as jp
from pytorch_distributed_template_tpu_torch.utils import promtext as tp


def _hist(mod, values):
    h = mod.LatencyHistogram()
    for v in values:
        h.observe(v)
    return h.snapshot()


_RNG = np.random.default_rng(4)
_LAT = [float(x) for x in _RNG.lognormal(-3.0, 1.5, 200)]

METRICS = [
    {},
    {"requests_total": 3, "queue_depth": 1, "latency": {"p50_s": 0.1},
     "ttft_seconds": jp.zero_histogram()},
    {"scheduler": "ContinuousBatchingService", "role": "both",
     "requests_total": 12, "slots": 8, "flag": True, "prefix_hit_rate": 0.25,
     "latency": {"p50_s": 0.011, "p99_s": 1.5, "n": 12, "label": "x"},
     "ttft_seconds": _hist(jp, _LAT), "e2e_seconds": _hist(jp, _LAT[:7]),
     "serve_path_paged_adopt_total": 4, "brownout_level": 2,
     "nested": {"a": {"b": 1}, "c": 2.5}, "empty": {}, "nothing": None},
]

BAD = [
    ("# TYPE pdt_serve_requests counter\npdt_serve_requests 3\n"),
    ("# TYPE pdt_serve_tokens_total gauge\npdt_serve_tokens_total 3\n"),
    ("# TYPE pdt_serve_ttft_seconds histogram\n"
     'pdt_serve_ttft_seconds_bucket{le="+Inf"} 2\n'
     "pdt_serve_ttft_seconds_sum 0.4\n"),
    ("# TYPE pdt_serve_ttft_seconds histogram\n"
     'pdt_serve_ttft_seconds_bucket{le="0.1"} 1\n'
     'pdt_serve_ttft_seconds_bucket{le="+Inf"} 1\n'
     "pdt_serve_ttft_seconds_sum 0.4\npdt_serve_ttft_seconds_count 2\n"),
    ("# TYPE pdt_serve_ttft_seconds histogram\n"
     'pdt_serve_ttft_seconds_bucket{le="0.1"} 3\n'
     'pdt_serve_ttft_seconds_bucket{le="0.5"} 1\n'
     'pdt_serve_ttft_seconds_bucket{le="+Inf"} 3\n'
     "pdt_serve_ttft_seconds_sum 0.4\npdt_serve_ttft_seconds_count 3\n"),
    "pdt_serve_orphan 1\n",
    ("# TYPE pdt_serve_x gauge\npdt_serve_x 1\n"
     "# TYPE pdt_serve_x gauge\npdt_serve_x 2\n"),
    "# TYPE 9bad gauge\n9bad 1\n",
    ("# TYPE pdt_serve_h histogram\n# TYPE pdt_serve_h_count gauge\n"
     'pdt_serve_h_bucket{le="+Inf"} 0\npdt_serve_h_sum 0\n'
     "pdt_serve_h_count 0\n"),
]


@pytest.mark.parametrize("i", range(len(METRICS)))
def test_prometheus_text_is_byte_identical(i):
    for prefix in ("pdt_serve", "pdt_fleet"):
        assert tp.prometheus_text(METRICS[i], prefix) == \
            jp.prometheus_text(METRICS[i], prefix)


def test_lint_gives_jax_violations_on_every_case():
    texts = BAD + [jp.prometheus_text(m) for m in METRICS] + [
        jp.prometheus_text({"latency_p50_s": 0.2, "latency": {"p50_s": 0.1}})]
    for text in texts:
        assert tp.lint_exposition(text) == jp.lint_exposition(text), text
    assert all(jp.lint_exposition(t) for t in BAD)


def test_histograms_add_and_quantiles_match():
    a, b = _hist(tp, _LAT[:120]), _hist(tp, _LAT[120:])
    assert a == _hist(jp, _LAT[:120]) and b == _hist(jp, _LAT[120:])
    for scale in (1.0, -1.0):
        got = tp.add_histograms(tp.zero_histogram(), a)
        want = jp.add_histograms(jp.zero_histogram(), a)
        assert tp.add_histograms(got, b, scale) == \
            jp.add_histograms(want, b, scale)
    total = tp.add_histograms(tp.add_histograms(tp.zero_histogram(), a), b)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert tp.histogram_quantile(total, q) == \
            jp.histogram_quantile(total, q)
    assert tp.histogram_quantile(tp.zero_histogram(), 0.5) is None
    assert tp.is_histogram(total) and not tp.is_histogram({"count": 1})
    vals = sorted(_LAT)
    for q in (0.0, 0.37, 0.5, 0.99, 1.0):
        assert tp.percentile(vals, q) == jp.percentile(vals, q)
