"""The port's cross-rank stats exchange against the JAX package's
``observability/crosshost.py``: ``local_stats_vector`` and ``aggregate``
give the same vectors and aggregates on the same records; and with two
gloo ranks (subprocesses) whose steps run through the fault hook, a
``slow_host`` plan on rank 1 alone makes rank 0's window record flag rank
1 as the straggler, both ranks compute the same aggregate, and only rank
0 counts the straggler window.

The ranks' steps are timed outside a DDP step on purpose: inside one,
the gradient all-reduce makes the fast rank wait for the slow one, so
both ranks' step walls carry the delay.
"""
import numpy as np
import pytest

from pytorch_distributed_template_tpu.observability import (
    crosshost as jcross,
)

from pytorch_distributed_template_tpu_torch.observability import crosshost

from test_torch_watchdog import run_ranks

WINDOWS = [
    [{"step": i, "wall_ms": 100.0 + i, "data_wait_ms": 4.0}
     for i in range(10)],
    [{"step": 0, "wall_ms": 3e4, "compile_events": [{"event": "x"}]},
     {"step": 1, "wall_ms": 50.0}, {"step": 2, "wall_ms": 70.0,
                                    "data_wait_ms": None}],
    [{"step": 0, "event": "anomaly"}],
    [],
]
MATRICES = [
    [[100.0, 1.0, 900.0, 0.0], [200.0, 2.0, 950.0, 0.0]],
    [[100.0, 1.0, 1.0, 1.0], [110.0, 1.0, 1.0, 1.0],
     [105.0, 1.0, 1.0, 1.0], [300.0, 9.0, 1.0, 1.0]],
    [[0.0, 0.0, 1.0, 1.0], [100.0, 0.0, 1.0, 1.0]],
    [[100.0, 0.0, 0.0, 0.0]],
]


@pytest.mark.parametrize("records", WINDOWS)
def test_local_stats_vector_matches(records):
    got = crosshost.local_stats_vector(records)
    want = jcross.local_stats_vector(records)
    assert got.dtype == want.dtype == np.float32 and got.shape == (4,)
    np.testing.assert_array_equal(got[:2], want[:2])   # rss: live memory


@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("threshold", [1.25, 1.5])
def test_aggregate_matches(matrix, threshold):
    assert crosshost.aggregate(np.array(matrix), threshold) == \
        jcross.aggregate(np.array(matrix), threshold)


def test_single_process_exchange_and_gating():
    agg = crosshost.CrossHostAggregator({"enabled": True})
    assert not crosshost.CrossHostAggregator().enabled   # auto: one rank
    assert agg.should_exchange(4, 2) and not agg.should_exchange(0, 2)
    assert not agg.should_exchange(3, 2)
    out = agg.exchange([{"wall_ms": 5.0}])
    assert set(out["hosts"]) == {"0"} and "straggler" not in out


STRAGGLER = r"""
import json, time
from pytorch_distributed_template_tpu_torch.observability import (
    crosshost, health, telemetry,
)
from pytorch_distributed_template_tpu_torch.parallel import dist
from pytorch_distributed_template_tpu_torch.resilience import faults

dist.initialize("cpu")
rank = dist.process_index()
faults.configure()                      # PDT_FAULTS: rank 1's only
rec = telemetry.FlightRecorder(run_dir=None, memory_every=0)
agg = crosshost.CrossHostAggregator({"enabled": True}, is_main=rank == 0)
out = None
for step in range(9):
    t0 = time.perf_counter()
    faults.on_step(step)
    time.sleep(0.02)
    fields = {"wall_ms": (time.perf_counter() - t0) * 1e3}
    if agg.should_exchange(step, 4):
        got = agg.exchange(rec.last(4))
        if rank == 0:
            fields.update(hosts=got["hosts"],
                          straggler=bool(got.get("straggler")),
                          straggler_hosts=got.get("straggler_hosts", []))
        out = got if step == 4 else out
    rec.record(step, **fields)
print(json.dumps({"rank": rank, "agg": out, "record": rec.last(5)[0],
                  "counter": health.health_counters()[
                      "straggler_windows_total"]}))
dist.shutdown()
"""


def test_two_ranks_flag_the_slow_rank():
    slow = ";".join(f"slow_host@step:{s}:120ms" for s in range(4))
    outs = run_ranks(STRAGGLER, env_per_rank={1: {"PDT_FAULTS": slow},
                                              0: {"PDT_FAULTS": ""}})
    r0, r1 = outs
    assert r0["agg"] == r1["agg"]
    assert r0["agg"]["straggler_hosts"] == [1]
    assert r0["record"]["step"] == 4 and r0["record"]["straggler"] is True
    assert r0["record"]["straggler_hosts"] == [1]
    assert set(r0["record"]["hosts"]) == {"0", "1"}
    assert (r0["counter"], r1["counter"]) == (1, 0)
