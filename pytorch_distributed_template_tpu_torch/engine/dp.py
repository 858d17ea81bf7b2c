"""DP x TP serving: ``dp`` independent engine groups behind one service,
the port of the JAX package's ``engine/dp.py``.

Group ``g`` owns cards ``[g tp, (g + 1) tp)`` (``parallel.tp.
dp_group_devices``): at tp 1 its weights, its pool and its scheduler's
device state live on card ``g`` of this process; at tp > 1 it is a
``parallel.serving_ranks.TensorParallelModel`` of its own (its own ranks
and process group). Nothing crosses groups; the only cross-group
machinery is the host-side choice of a group per request
(:meth:`DataParallelService._pick`): the group whose pool holds the
deepest cached prefix, unless its load (queued + live requests) exceeds
the least-loaded group's by more than :data:`LOAD_SPREAD`; otherwise the
least-loaded, ties rotating. A request's tokens depend only on its own
prompt, seed and sampling, and every group holds the same weights, so
which group serves it does not change its output.

Left to later slices, each refused naming its ROADMAP item: page shipping
(``prefill_export``, ``export_cached_pages``, ``import_remote_pages``;
A3a.4). Brownout and the SLO watcher (A3a.5, A3a.7) have no engine here to
merge.
"""
from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor

from ..utils.promtext import percentile

logger = logging.getLogger(__name__)

_SHIPPING = ("page shipping between replicas (disaggregated prefill/"
             "decode) is a later slice of the port (ROADMAP A3a.4)")
#: engine stats that are one value per group, not a count to add up
_GAUGES = ("tp_degree",)
#: how many more requests (queued + live) than the least-loaded group the
#: group holding a request's deepest cached prefix may carry and still get
#: it (the JAX package's default ``load_spread``)
LOAD_SPREAD = 4


def _close(models) -> None:
    for model in models:
        if hasattr(model, "close"):
            model.close()


class _StatsView(dict):
    """The facade's ``stats``: a fresh merge of the group engines'
    counters and the facade's own. A write (``serve.py`` bumping a
    counter) forwards its delta to the facade's own store, so it
    survives into the next snapshot."""

    def __init__(self, data, own):
        super().__init__(data)
        self._own = own

    def __setitem__(self, key, value):
        base = self.get(key, 0)
        if isinstance(value, (int, float)) and isinstance(
                base, (int, float)):
            self._own[key] = self._own.get(key, 0) + (value - base)
        else:
            self._own[key] = value
        super().__setitem__(key, value)


class DataParallelService:
    """``dp`` group engines behind the surface ``serve.py`` speaks
    (``generate``, ``validate_request``, ``stats``, the metrics
    accessors), so the HTTP layer cannot tell dp 4 from dp 1."""

    def __init__(self, engines, models=()):
        if not engines:
            raise ValueError("DataParallelService needs >= 1 engine")
        self._engines = list(engines)
        self._models = list(models)      # the groups' models it built
        self._rr = 0
        self._lock = threading.Lock()
        self._own_stats: dict = {}
        e0 = self._engines[0]
        self.model = e0.model
        self.arch = e0.arch
        self.vocab = e0.vocab
        self.tokenizer = e0.tokenizer
        self.device = e0.device
        self.pool_refusal_reason = getattr(e0, "pool_refusal_reason", "")
        self.tp = e0.tp
        self.dp = len(self._engines)
        self.STREAM_DELTAS = bool(getattr(e0, "STREAM_DELTAS", False))

    # ---- construction -----------------------------------------------------

    @classmethod
    def from_model_factory(cls, factory, dp: int, tp: int, service_cls,
                           tokenizer=None, device="cuda", service_kw=None):
        """``dp`` group engines: ``factory(g)`` returns group ``g``'s model
        (on card ``g`` at tp 1, a TP group of its own at tp > 1; the
        facade closes those it built)."""
        from ..parallel.tp import validate_dp_geometry

        dp, tp = int(dp), int(tp)
        validate_dp_geometry(dp, tp, device)
        # the groups load their weights (and start their ranks) at once
        with ThreadPoolExecutor(dp) as pool:
            futures = [pool.submit(factory, g) for g in range(dp)]
        models, errors = [], []
        for f in futures:
            try:
                models.append(f.result())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
        engines = []
        try:
            if errors:
                raise errors[0]
            for g, model in enumerate(models):
                engines.append(service_cls.from_model(
                    model, tokenizer, device=model.device,
                    **dict(service_kw or {})))
                logger.info("dp group %d/%d ready (tp=%d, %s)", g + 1, dp,
                            tp, getattr(model, "devices", model.device))
        except BaseException:
            for e in engines:
                e.close()
            _close(models)
            raise
        return cls(engines, models=models)

    @classmethod
    def build_from_config(cls, config, service_cls, device=None, dp: int = 2,
                          tp: int = 1, service_kw=None):
        """The ``serve.py`` entry: each group loads the artifact onto its
        own cards (``load_generation_stack(group=g)``)."""
        from ..data.tokenizer import tokenizer_from_config
        from ..utils.util import resolve_device
        from .serving import load_generation_stack

        device = resolve_device(device)

        def factory(g):
            model, _ = load_generation_stack(
                config, device=device, tensor_parallel=tp, group=g)
            return model

        return cls.from_model_factory(
            factory, dp, tp, service_cls,
            tokenizer=tokenizer_from_config(config), device=device,
            service_kw=service_kw)

    def close(self) -> None:
        """Stop every group (its scheduler, and the ranks of the TP groups
        the facade built)."""
        for e in self._engines:
            e.close()
        _close(self._models)

    # ---- placement --------------------------------------------------------

    def _loads(self) -> list:
        return [e.queue_depth() + e.live_slots()
                if hasattr(e, "queue_depth") else 0
                for e in self._engines]

    def _pick(self, ids=None) -> int:
        """The group for a request of prompt ``ids``: the deepest cached
        prefix wins unless that group's load exceeds the least-loaded's
        by more than :data:`LOAD_SPREAD`; no match: the least-loaded, ties
        rotating."""
        with self._lock:
            rr = self._rr
            self._rr += 1
        loads = self._loads()
        least = min(loads)
        tied = [i for i, n in enumerate(loads) if n <= least]
        least_i = tied[rr % len(tied)]
        if ids:
            best_i, best_c = None, 0
            for i, e in enumerate(self._engines):
                pf = getattr(e, "_prefix", None)
                if pf is None:
                    continue
                c = pf.cached_block_count(ids)
                if c > best_c:
                    best_c, best_i = c, i
            if best_i is not None and loads[best_i] - least <= LOAD_SPREAD:
                return best_i
        return least_i

    # ---- the service surface ----------------------------------------------

    def generate(self, prompt=None, prompt_ids=None, **kw) -> dict:
        try:
            ids = self._engines[0].encode_prompt(prompt, prompt_ids)
        except ValueError:
            ids = None        # the group's engine raises the real 400
        return self._engines[self._pick(ids)].generate(
            prompt=prompt, prompt_ids=prompt_ids, **kw)

    def prefill_export(self, *args, **kw) -> dict:
        raise NotImplementedError(_SHIPPING)

    def export_cached_pages(self, *args, **kw) -> dict:
        raise NotImplementedError(_SHIPPING)

    def import_remote_pages(self, *args, **kw) -> dict:
        raise NotImplementedError(_SHIPPING)

    def validate_request(self, req: dict) -> None:
        self._engines[0].validate_request(req)

    def encode_prompt(self, prompt=None, prompt_ids=None):
        return self._engines[0].encode_prompt(prompt, prompt_ids)

    def encode_stop(self, stop):
        return self._engines[0].encode_stop(stop)

    # ---- observability ----------------------------------------------------

    @property
    def stats(self) -> dict:
        merged: dict = {"dp_groups": self.dp}
        for e in self._engines:
            for k, v in (getattr(e, "stats", None) or {}).items():
                if isinstance(v, bool):
                    continue
                if k in _GAUGES:
                    merged.setdefault(k, v)
                elif isinstance(v, (int, float)):
                    merged[k] = merged.get(k, 0) + v
        for k, v in self._own_stats.items():
            if isinstance(v, (int, float)):
                merged[k] = merged.get(k, 0) + v
            else:
                merged[k] = v
        return _StatsView(merged, self._own_stats)

    def queue_depth(self) -> int:
        return sum(e.queue_depth() for e in self._engines
                   if hasattr(e, "queue_depth"))

    def live_slots(self) -> int:
        return sum(e.live_slots() for e in self._engines
                   if hasattr(e, "live_slots"))

    def latency_percentiles(self) -> dict:
        lats = sorted(x for e in self._engines
                      for x in list(getattr(e, "_latencies", ()))[-1024:])
        if not lats:
            return {}
        out = {"p50_s": round(percentile(lats, 0.5), 4),
               "p95_s": round(percentile(lats, 0.95), 4),
               "p99_s": round(percentile(lats, 0.99), 4),
               "n": len(lats)}
        ttfts = sorted(x for e in self._engines
                       for x in list(getattr(e, "_ttfts", ()))[-1024:])
        if ttfts:
            out.update(ttft_p50_s=round(percentile(ttfts, 0.5), 4),
                       ttft_p95_s=round(percentile(ttfts, 0.95), 4),
                       ttft_p99_s=round(percentile(ttfts, 0.99), 4))
        return out

    def prefix_cache_stats(self):
        snaps = [s for s in (e.prefix_cache_stats()
                             for e in self._engines) if s]
        if not snaps:
            return None
        out: dict = {}
        for k, v0 in snaps[0].items():
            if isinstance(v0, bool):
                out[k] = all(s.get(k, False) for s in snaps)
            elif isinstance(v0, (int, float)):
                out[k] = sum(s.get(k, 0) for s in snaps)
            else:
                out[k] = v0
        lk = out.get("prefix_lookups", 0)
        out["prefix_hit_rate"] = round(
            out.get("prefix_hit_requests", 0) / lk, 4) if lk else 0.0
        return out

    def tp_stats(self) -> dict:
        # every group has the same geometry: group 0 speaks for all
        return self._engines[0].tp_stats()
