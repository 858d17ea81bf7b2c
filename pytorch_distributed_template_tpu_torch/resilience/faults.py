"""Deterministic fault injection: a parsed plan + cheap hook points (a
copy of the JAX package's ``resilience/faults.py``; the port keeps its own,
since it imports nothing of the JAX package).

The port wires the training hooks: ``on_step`` and ``nan_grad_step`` in
``engine/trainer.py`` (the NaN is added to the summed gradients by
``engine/steps.py``), ``on_loader_batch`` in ``data/loader.py`` and
``on_checkpoint_save`` in ``checkpoint/manager.py``; and the KV pool's:
``on_tier_event`` (``slow_spill``, ``corrupt_spill``, ``tier_exhaust``) and
``on_page_adopt`` (``corrupt_page``) in ``engine/kvcache.py``, and
``on_peer_pull`` (``peer_pull_timeout``) where a service lands pages a peer
pull sent (``engine/serving.py::import_remote_pages``, ``origin="pull"``;
the JAX package fires it in its fleet manager, which the port has not
yet); and the serving ones: ``on_serve_tick`` (``slow_decode``, ``hang``,
``pool_exhaust``) once per continuous-scheduler round in
``engine/continuous.py``, ``on_serve_request`` (``stall_stream``) in
``serve.py``'s streamed ``/generate``, and ``on_artifact_load``
(``ckpt_corrupt``) in ``checkpoint/serving.py::verify_artifact_manifest``.
The fleet's hooks (``on_proxy_request``) wait for the fleet (ROADMAP
A13).

Nothing in a training framework's recovery story is real until a test
can *make* the failure happen: this module turns a one-line plan into
deterministic faults fired at exact steps/batches/epochs, so the
health monitor's NaN forensics, the non-finite guard, the watchdog and
(in the JAX package) the supervisor restart path can be exercised on
demand instead of waiting for production to break.

Plan grammar (``;``-separated specs)::

    PDT_FAULTS="kill@step:120;nan_grad@step:40;slow_host@step:30:2.5s;\
loader_raise@batch:7;ckpt_write_fail@epoch:2"

    <kind>@<unit>:<at>[:<arg>][@attempt:<n|any>]

Kinds and their designated detectors/recovery:

===============  ======  ==========================================
kind             unit    effect at the hook point
===============  ======  ==========================================
``kill``         step    SIGKILL this process *before* dispatching
                         the step (hard crash / preemption without
                         notice; nothing flushes, by design)
``crash``        step    raise :class:`FaultInjected` before the
                         step (unhandled-exception path → emergency
                         checkpoint → supervisor restart)
``nan_grad``     step    poison every gradient leaf with NaN inside
                         the compiled step (health monitor +
                         ``skip_nonfinite`` guard path); injected at
                         trace time via ``state.step == at``
``slow_host``    step    ``time.sleep(arg)`` before the step (host
                         straggler / hang; arg like ``2.5s``/``250ms``,
                         default 1s) — trips the watchdog and, when
                         long enough, the supervisor's heartbeat
                         hang detection
``loader_raise`` batch   raise from the data loader at per-epoch
                         batch index ``at`` (input-pipeline failure)
``ckpt_write_fail`` epoch raise from ``CheckpointManager.save``/
                         ``save_interval`` at epoch ``at``; flagged
                         ``is_checkpoint_fault`` so the emergency
                         path knows NOT to re-enter the checkpointer
===============  ======  ==========================================

Serving-path kinds — same grammar, attempt-gated and
once-per-process like the training kinds, but triggered on the
serving stack's own ordinals instead of training steps:

==================  ====  ==========================================
kind                unit  effect at the hook point
==================  ====  ==========================================
``slow_decode``     tick  ``time.sleep(arg)`` inside the continuous
                          scheduler's round when its chunk counter
                          reaches ``at`` (a slow replica: everything
                          in flight there stalls; hedging/deadlines
                          are the designated mitigation)
``hang``            tick  the scheduler round blocks FOREVER at
                          chunk ``at`` while ``/healthz`` and
                          ``/metrics`` keep answering — the wedge
                          the fleet poller's frozen-progress
                          detection exists to catch
``pool_exhaust``    tick  the paged prefix pool reports dry for
                          ``arg`` (default 1s) starting at chunk
                          ``at``: admissions defer, queues build,
                          brownout pressure rises
``stall_stream``    req   the ``at``-th ``/generate`` request of
                          this serve.py process stalls its SSE
                          stream after the first delta WITHOUT
                          closing (the router's deadline-bounded
                          read is what frees the client)
``proxy_latency``   req   ``time.sleep(arg)`` before proxying the
                          ``at``-th router request (a slow hop)
``proxy_blackhole`` req   the first proxy attempt of the ``at``-th
                          router request never reaches a replica
                          and never answers (hedge/timeout territory)
``ckpt_corrupt``    load  the ``at``-th serving-artifact load sees
                          a corrupted manifest digest: the loader
                          must refuse LOUDLY instead of serving
                          garbage weights
==================  ====  ==========================================

KV-tier kinds — the spill hierarchy's fault surface.
``evt`` is the process-global tier-operation ordinal (every demote or
promote the spill tier performs advances it); ``pull`` is the
process-global peer-page-pull ordinal (the fleet manager's
miss-driven pulls and restart re-warm pulls both count):

===================  ====  =========================================
kind                 unit  effect at the hook point
===================  ====  =========================================
``slow_spill``       evt   ``time.sleep(arg)`` before the tier
                           operation (a slow host/disk tier; the
                           admission simply takes longer — nothing
                           may strand)
``corrupt_spill``    evt   flip one byte of the most recently
                           DEMOTED blob after its checksum was
                           recorded: the next read of that entry
                           must fail verification and recompute
                           cold, never serve the torn page
``tier_exhaust``     evt   the spill tier reports full for ``arg``
                           (default 1s): eviction degrades to the
                           classic destroy-on-evict, counted, with
                           zero correctness impact
``peer_pull_timeout`` pull the ``at``-th peer page pull times out
                           (sleeps ``arg``, then fails): the router
                           falls back to a cold prefill — a pull is
                           an optimization, never a dependency
===================  ====  =========================================

Token-integrity kind — the shadow auditor's self-test.
``evt`` here is the pool's page-ADOPTION ordinal (every ``adopt()``
call that lands at least one block advances it — its own counter,
independent of the spill tier's operation ordinal above):

===================  ====  =========================================
kind                 unit  effect at the hook point
===================  ====  =========================================
``corrupt_page``     evt   overwrite the first block adopted by the
                           ``at``-th adoption event with a constant
                           pattern (applied at the pool's next safe
                           device point): warm consumers of that
                           cached page serve WRONG tokens while the
                           cold no-pool replay stays clean — exactly
                           the silent divergence the shadow-replay
                           auditor exists to catch
===================  ====  =========================================

Attempt gating: each spec fires only on one supervisor attempt
(default the first), so a ``kill@step:5`` chaos run dies once and the
restarted attempt — the supervisor exports ``PDT_ATTEMPT=n`` — sails
past the same step. ``@attempt:any`` disables the gate. Every spec
additionally fires at most once per process.

Stdlib-only on purpose: the loader and checkpoint hooks import this
module. The one in-step fault (``nan_grad``) is applied by
``engine/steps.py`` from the plain int this module hands it.
"""
from __future__ import annotations

import logging
import os
import re
import signal
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

logger = logging.getLogger(__name__)

# kind -> the trigger unit its hook point understands
KINDS = {
    "kill": "step",
    "crash": "step",
    "nan_grad": "step",
    "slow_host": "step",
    "loader_raise": "batch",
    "ckpt_write_fail": "epoch",
    # serving-path kinds: tick = the continuous scheduler's
    # chunk counter, req = this process's /generate ordinal (router or
    # replica — each counts its own), load = serving-artifact load
    # ordinal. Same attempt gating + once-per-process as the training
    # kinds; the supervisor's PDT_ATTEMPT export means a restarted
    # replica sails past the fault that killed/wedged attempt 1.
    "slow_decode": "tick",
    "hang": "tick",
    "pool_exhaust": "tick",
    "stall_stream": "req",
    "proxy_latency": "req",
    "proxy_blackhole": "req",
    "ckpt_corrupt": "load",
    # KV-tier kinds: evt = the spill tier's operation
    # ordinal (demotes + promotes), pull = the fleet manager's peer
    # page-pull ordinal. Same attempt gating + once-per-process rules.
    "slow_spill": "evt",
    "corrupt_spill": "evt",
    "tier_exhaust": "evt",
    "peer_pull_timeout": "pull",
    # token-integrity kind: evt = the pool's page-adoption
    # ordinal (separate counter from the spill tier's operation
    # ordinal — KINDS maps unit per kind, so the grammar token is the
    # same while each kind counts its own events)
    "corrupt_page": "evt",
}

#: kinds whose optional arg is a duration (validated at parse time)
_DURATION_KINDS = ("slow_host", "slow_decode", "pool_exhaust",
                   "stall_stream", "proxy_latency", "slow_spill",
                   "tier_exhaust", "peer_pull_timeout")

ENV_PLAN = "PDT_FAULTS"
ENV_ATTEMPT = "PDT_ATTEMPT"


class FaultInjected(RuntimeError):
    """An injected fault firing as an exception.

    ``is_checkpoint_fault`` marks faults raised from inside the
    checkpoint manager — the trainer's emergency-save path skips the
    save when the checkpointer itself is the thing that failed.
    """

    def __init__(self, spec: "FaultSpec", message: str):
        super().__init__(message)
        self.kind = spec.kind
        self.spec = spec
        self.is_checkpoint_fault = spec.kind == "ckpt_write_fail"


_DURATION = re.compile(r"^(\d+(?:\.\d+)?)(ms|s)?$")


def _parse_duration_s(text: str) -> float:
    m = _DURATION.match(text)
    if not m:
        raise ValueError(f"bad duration {text!r} (want e.g. '2.5s', '250ms')")
    value = float(m.group(1))
    return value / 1e3 if m.group(2) == "ms" else value


@dataclass
class FaultSpec:
    kind: str
    unit: str
    at: int
    arg: Optional[str] = None
    attempt: Optional[int] = 1     # None = any attempt
    fired: bool = field(default=False, compare=False)

    @property
    def duration_s(self) -> float:
        return _parse_duration_s(self.arg) if self.arg else 1.0

    def describe(self) -> str:
        out = f"{self.kind}@{self.unit}:{self.at}"
        if self.arg:
            out += f":{self.arg}"
        if self.attempt != 1:
            out += f"@attempt:{self.attempt if self.attempt else 'any'}"
        return out


@dataclass
class FaultPlan:
    specs: List[FaultSpec] = field(default_factory=list)

    @classmethod
    def parse(cls, text: Optional[str]) -> "FaultPlan":
        specs: List[FaultSpec] = []
        for token in (text or "").split(";"):
            token = token.strip()
            if not token:
                continue
            parts = token.split("@")
            if len(parts) < 2:
                raise ValueError(
                    f"bad fault spec {token!r}: want kind@unit:at[:arg]"
                )
            kind = parts[0].strip()
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} (known: {sorted(KINDS)})"
                )
            attempt: Optional[int] = 1
            for extra in parts[2:]:
                key, _, val = extra.partition(":")
                if key.strip() != "attempt":
                    raise ValueError(
                        f"bad fault qualifier {extra!r} in {token!r} "
                        "(only @attempt:<n|any> is understood)"
                    )
                attempt = None if val.strip() == "any" else int(val)
            trigger = parts[1].split(":")
            unit = trigger[0].strip()
            if unit != KINDS[kind]:
                raise ValueError(
                    f"fault {kind!r} triggers on {KINDS[kind]!r}, "
                    f"not {unit!r}"
                )
            if len(trigger) < 2 or len(trigger) > 3:
                raise ValueError(
                    f"bad trigger {parts[1]!r} in {token!r}: "
                    "want unit:at[:arg]"
                )
            at = int(trigger[1])
            arg = trigger[2].strip() if len(trigger) == 3 else None
            if kind in _DURATION_KINDS and arg is not None:
                _parse_duration_s(arg)  # validate at parse time
            specs.append(FaultSpec(kind, unit, at, arg, attempt))
        return cls(specs)

    def active(self, attempt: int) -> List[FaultSpec]:
        return [s for s in self.specs
                if s.attempt is None or s.attempt == attempt]

    def __bool__(self) -> bool:
        return bool(self.specs)


# ---------------------------------------------------------------------------
# process-global plan + hook points
# ---------------------------------------------------------------------------

_plan: Optional[FaultPlan] = None
_attempt: int = 1
_active: List[FaultSpec] = []
# id() of the loader loader_raise targets; None = any loader. The
# trainer binds its TRAIN loader so a validation/eval pass sharing the
# same loader class cannot consume the one-shot spec at ITS batch 7.
_watched_loader_id: Optional[int] = None


def configure(text: Optional[str] = None,
              attempt: Optional[int] = None) -> FaultPlan:
    """(Re)install the process fault plan.

    ``PDT_FAULTS`` in the environment wins over ``text`` (the operator/
    supervisor-level injection path must be able to override a config
    file); both absent installs an empty plan. ``attempt`` defaults to
    ``PDT_ATTEMPT`` (exported by the supervisor), else 1.
    """
    global _plan, _attempt, _active
    env = os.environ.get(ENV_PLAN)
    _plan = FaultPlan.parse(env if env else text)
    if attempt is None:
        try:
            attempt = int(os.environ.get(ENV_ATTEMPT, "1"))
        except ValueError:
            attempt = 1
    _attempt = attempt
    _active = _plan.active(_attempt)
    if _active:
        logger.warning(
            "FAULT PLAN ACTIVE (attempt %d): %s", _attempt,
            "; ".join(s.describe() for s in _active),
        )
    return _plan


def reset() -> None:
    """Drop the plan entirely (tests)."""
    global _plan, _attempt, _active, _watched_loader_id, _load_ordinal
    global _tier_ordinal, _pull_ordinal, _page_ordinal
    _plan, _attempt, _active, _watched_loader_id = None, 1, [], None
    _load_ordinal = 0
    _tier_ordinal = 0
    _pull_ordinal = 0
    _page_ordinal = 0


def watch_loader(loader) -> None:
    """Bind ``loader_raise`` to one loader instance (the trainer binds
    its train loader). Unbound (the default, e.g. a bare loader in a
    test), the hook fires from any loader."""
    global _watched_loader_id
    _watched_loader_id = id(loader) if loader is not None else None


def _ensure_configured() -> None:
    if _plan is None:
        configure()


def _take(kind: str, value: int) -> Optional[FaultSpec]:
    """The not-yet-fired active spec of ``kind`` triggering at
    ``value``, marked fired; None otherwise. O(active specs) — the
    plan is empty in production, a handful of entries under chaos."""
    for s in _active:
        if s.kind == kind and not s.fired and s.at == int(value):
            s.fired = True
            return s
    return None


def on_step(step: int) -> None:
    """Trainer-loop hook, called once per batch with the global step,
    BEFORE the step is dispatched (``kill@step:N`` ⇒ exactly N steps
    completed). Order: slow_host (then continue), crash (raise),
    kill (never returns)."""
    if _plan is None:
        _ensure_configured()
    if not _active:
        return
    s = _take("slow_host", step)
    if s is not None:
        logger.warning("fault slow_host: sleeping %.3fs at step %d",
                       s.duration_s, step)
        time.sleep(s.duration_s)
    s = _take("crash", step)
    if s is not None:
        raise FaultInjected(
            s, f"injected crash at step {step} ({s.describe()})"
        )
    s = _take("kill", step)
    if s is not None:
        # raw write + SIGKILL: simulate a hard host loss — no flushes,
        # no atexit, no emergency checkpoint. The surviving evidence is
        # whatever was already durable, exactly like a real preemption
        # without notice.
        try:
            os.write(2, f"fault kill: SIGKILL at step {step}\n".encode())
        except OSError:
            pass
        os.kill(os.getpid(), signal.SIGKILL)


def on_loader_batch(batch_index: int, loader=None) -> None:
    """Data-loader hook (per-epoch batch ordinal, before the gather).

    ``loader``: the iterating loader instance, checked against
    :func:`watch_loader`'s binding so only the targeted (train) input
    pipeline can fire the one-shot spec."""
    if _plan is None:
        _ensure_configured()
    if not _active:
        return
    if (_watched_loader_id is not None and loader is not None
            and id(loader) != _watched_loader_id):
        return
    s = _take("loader_raise", batch_index)
    if s is not None:
        raise FaultInjected(
            s, f"injected loader failure at batch {batch_index} "
               f"({s.describe()})"
        )


def on_checkpoint_save(epoch: int) -> None:
    """Checkpoint-manager hook (save/save_interval entry)."""
    if _plan is None:
        _ensure_configured()
    if not _active:
        return
    s = _take("ckpt_write_fail", epoch)
    if s is not None:
        raise FaultInjected(
            s, f"injected checkpoint write failure at epoch {epoch} "
               f"({s.describe()})"
        )


def nan_grad_step() -> Optional[int]:
    """The global step whose gradients should be NaN-poisoned, or None.

    Read once at trainer build time and handed to the train step
    (``engine/steps.make_train_step(inject_nan_grad_step=...)``), which
    compares it with its own step counter on the host: the fault fires
    at the exact step with no device read.
    """
    _ensure_configured()
    for s in _active:
        if s.kind == "nan_grad":
            return s.at
    return None


# ---------------------------------------------------------------------------
# serving-path hook points
# ---------------------------------------------------------------------------

#: serving-artifact load ordinal (1-based) for the ``load`` unit
_load_ordinal = 0


def on_serve_tick(tick: int):
    """Continuous-scheduler hook, called once per scheduler round with
    the engine's chunk counter. Handles ``slow_decode`` (sleep, then
    continue) and ``hang`` (block this thread FOREVER — ``/healthz``
    keeps answering from the HTTP threads, which is exactly the wedge
    the fleet poller's frozen-progress detection exists for) in place;
    returns the fired ``pool_exhaust`` spec (the engine owns the drain
    window) or None."""
    if _plan is None:
        _ensure_configured()
    if not _active:
        return None
    s = _take("slow_decode", tick)
    if s is not None:
        logger.warning("fault slow_decode: sleeping %.3fs at tick %d",
                       s.duration_s, tick)
        time.sleep(s.duration_s)
    s = _take("hang", tick)
    if s is not None:
        logger.warning("fault hang: wedging scheduler at tick %d "
                       "(healthz stays up)", tick)
        import threading

        threading.Event().wait()       # never set: wedged by design
    return _take("pool_exhaust", tick)


def on_serve_request(ordinal: int):
    """Replica request hook (serve.py ``/generate`` ordinal, 1-based):
    returns the fired ``stall_stream`` spec (the SSE handler owns the
    stall) or None."""
    if _plan is None:
        _ensure_configured()
    if not _active:
        return None
    return _take("stall_stream", ordinal)


def on_proxy_request(ordinal: int):
    """Router request hook (front-door ``/generate`` ordinal,
    1-based). Handles ``proxy_latency`` in place (sleep before the
    hop); returns the fired ``proxy_blackhole`` spec (the router's
    proxy attempt owns the blackhole) or None."""
    if _plan is None:
        _ensure_configured()
    if not _active:
        return None
    s = _take("proxy_latency", ordinal)
    if s is not None:
        logger.warning("fault proxy_latency: sleeping %.3fs before "
                       "request %d", s.duration_s, ordinal)
        time.sleep(s.duration_s)
    return _take("proxy_blackhole", ordinal)


def on_artifact_load():
    """Serving-artifact load hook (checkpoint/manager manifest
    verification): each call advances the process-global load ordinal;
    returns the fired ``ckpt_corrupt`` spec or None. The verifier
    perturbs its OBSERVED digest when the spec fires — deterministic
    corruption without destroying the artifact on disk."""
    global _load_ordinal
    if _plan is None:
        _ensure_configured()
    _load_ordinal += 1
    if not _active:
        return None
    return _take("ckpt_corrupt", _load_ordinal)


#: spill-tier operation ordinal (1-based) for the ``evt`` unit —
#: every demote or promote the tier performs advances it
_tier_ordinal = 0

#: peer page-pull ordinal (1-based) for the ``pull`` unit
_pull_ordinal = 0


def on_tier_event():
    """Spill-tier hook (the JAX package's engine/kvcache.SpillTier): each
    call advances the tier-operation ordinal. ``slow_spill`` sleeps
    in place (the tier is just slow; the caller proceeds); returns
    ``{"corrupt": spec|None, "exhaust": spec|None}`` — the tier owns
    the byte flip and the full-window — or None with no plan active."""
    global _tier_ordinal
    if _plan is None:
        _ensure_configured()
    _tier_ordinal += 1
    if not _active:
        return None
    s = _take("slow_spill", _tier_ordinal)
    if s is not None:
        logger.warning("fault slow_spill: sleeping %.3fs at tier op %d",
                       s.duration_s, _tier_ordinal)
        time.sleep(s.duration_s)
    return {"corrupt": _take("corrupt_spill", _tier_ordinal),
            "exhaust": _take("tier_exhaust", _tier_ordinal)}


#: pool page-adoption ordinal (1-based) for the
#: ``corrupt_page`` kind — every adopt() landing >= 1 block advances it
_page_ordinal = 0


def on_page_adopt():
    """Pool page-adoption hook (the JAX package's
    engine/kvcache.PrefixCache.adopt): each adoption event advances the
    page ordinal; returns the fired ``corrupt_page`` spec (the pool owns
    the overwrite — deferred to its next safe device point so a mid-tick
    pool donation can never invalidate a live engine cache) or None."""
    global _page_ordinal
    if _plan is None:
        _ensure_configured()
    _page_ordinal += 1
    if not _active:
        return None
    return _take("corrupt_page", _page_ordinal)


def on_peer_pull():
    """Peer page-pull hook (the JAX package's
    fleet/replicas.FleetManager):
    each call advances the pull ordinal; returns the fired
    ``peer_pull_timeout`` spec (the caller sleeps its duration and
    then treats the pull as timed out — cold-prefill fallback) or
    None."""
    global _pull_ordinal
    if _plan is None:
        _ensure_configured()
    _pull_ordinal += 1
    if not _active:
        return None
    return _take("peer_pull_timeout", _pull_ordinal)


def install_from_env_or_config(config_text: Optional[str]) -> None:
    """Trainer-entry helper: (re)configure from PDT_FAULTS / the
    ``trainer.faults`` config string. Called once per Trainer build so
    a fresh trainer in the same process gets fresh one-shot flags."""
    configure(config_text)


def main(argv=None) -> int:
    """``python -m ...resilience.faults 'PLAN'`` — parse + describe a
    plan (CI/operator sanity check; exit 2 on a malformed plan)."""
    text = (argv or sys.argv[1:] or [os.environ.get(ENV_PLAN, "")])[0]
    try:
        plan = FaultPlan.parse(text)
    except ValueError as e:
        print(f"invalid fault plan: {e}", file=sys.stderr)
        return 2
    for s in plan.specs:
        print(s.describe())
    return 0


if __name__ == "__main__":
    sys.exit(main())
