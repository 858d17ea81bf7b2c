"""The ranks of a tensor-parallel serving group: one process per card,
driven by the serving process (parallel/tp.py has the design).

:class:`TensorParallelModel` is what the serving engines hold in place of
a model. It starts ``tp`` rank processes (``python -m`` this module; no
``torchrun``), which join a process group of their own (NCCL on the
cards, gloo on the CPU; rank 0 opens the group's store on a port the
kernel picks and names it back) and each load their Megatron slice of the
artifact (``engine.serving.load_serving_model`` with the group's mesh).
It answers the calls the engines make of a model (``new_cache``,
``new_paged_cache``, the forward, ``kv_cache_spec``, the model's sizes):
a cache or the pool is a :class:`RemoteCache` handle of objects every
rank holds at its own KV heads; a forward sends every rank the call's
integer inputs over a local socket (``multiprocessing.connection``, a
Linux abstract Unix socket) and
returns rank 0's last-position logits ``[B, 1, V]`` (gathered over the
vocabulary on the ranks) as a CPU tensor. Every rank runs every call, in
the order sent, so their collectives pair up.

Failure: a rank that raises sends its traceback and exits; one that dies
closes its socket. Either wakes the serving process at once (it waits on
every rank's socket, and a watcher thread polls the processes between
calls): the group is marked failed, every rank process is killed (one may
be blocked in a collective with the dead one), the ``on_failure``
callbacks run (``serve.py`` shuts down and exits non-zero) and this and
every later call raise :class:`RankFailure`. A call that gets no answer in
``timeout`` seconds fails the same way. :meth:`TensorParallelModel.close`
stops the ranks; a rank whose serving process goes away exits.
"""
from __future__ import annotations

import atexit
import itertools
import logging
import os
import secrets
import subprocess
import sys
import threading
import time
import traceback
import weakref
from dataclasses import dataclass, field
from multiprocessing.connection import Client, Listener, wait
from pathlib import Path

import numpy as np
import torch

from .tp import serving_devices, validate_tp_geometry

logger = logging.getLogger(__name__)

#: the directory holding the package (put on the ranks' PYTHONPATH)
_ROOT = Path(__file__).resolve().parents[2]
_ENV = "PDT_SERVING_RANK"          # "<rank>:<authkey hex>:<socket name>"
#: the model attributes the serving process mirrors from rank 0
_ATTRS = ("vocab_size", "n_layer", "n_head", "n_kv_head", "d_model",
          "d_ff", "max_len", "window", "dtype", "kv_quant", "rope_base",
          "head_dim", "attn_impl")


class RankFailure(RuntimeError):
    """A rank of a tensor-parallel serving group failed: it raised, it
    exited, or the group did not answer in time. The group is stopped."""


@dataclass
class RemoteCache:
    """A decode cache or the paged pool as the serving process sees it:
    the id of the object each rank holds at its own KV heads, ``layers``
    (``models.llama.PagedLayer`` of meta tensors: rank 0's page shapes and
    dtypes, for the pool's accounting; empty for a contiguous cache), and
    a contiguous cache's position counter."""
    cid: int
    paged: bool
    layers: list = field(default_factory=list)
    pos_index: int = 0


def _host(x):
    """An engine input as a numpy array (None stays None)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TensorParallelModel:
    """A Llama-family model served by ``tp`` rank processes on cards
    ``first .. first + tp - 1`` (or ``tp`` gloo ranks on the CPU).

    ``arch``: the config's ``{"type", "args"}``; ``resume``: the serving
    artifact, whose manifest the caller has verified. The engine state
    and the returned logits live on the CPU (:attr:`device`): the serving
    process holds no card of the group."""

    def __init__(self, arch: dict, resume, tp: int, device="cuda",
                 first: int = 0, timeout: float = 900.0):
        from ..config.registry import MODELS, resolve
        from .. import models  # noqa: F401  (registers the families)

        self.tensor_parallel = int(tp)
        shape = resolve(MODELS, arch["type"])(
            **dict(arch.get("args") or {}), device="meta")
        validate_tp_geometry(shape, self.tensor_parallel)
        self.devices = serving_devices(self.tensor_parallel, device, first)
        self.device = torch.device("cpu")
        self.timeout = float(timeout)
        self.on_failure: list = []
        self._lock = threading.Lock()        # one exchange at a time
        self.round_trip_s = 0.0              # forward calls, send to reply
        self._state = threading.Lock()       # failure and close
        self._failure = None
        self._closed = False
        self._ids = itertools.count()
        self._dead: list = []                # caches to free on the ranks
        self._procs, self._conns = [], []
        key = secrets.token_bytes(16)
        # a Linux abstract socket: no file, and none of TCP's small-write
        # delays on the per-call round trip
        self._socket = f"pdt-serving-{secrets.token_hex(8)}"
        listener = Listener("\0" + self._socket, family="AF_UNIX",
                            authkey=key)
        try:
            self._spawn(listener, key)
            spec = {"arch": dict(arch), "resume": str(resume),
                    "world": self.tensor_parallel}
            # rank 0 binds the group's store on a port of its own choosing
            # and names it; the others join that store
            self._conns[0].send(dict(spec, rank=0,
                                     device=str(self.devices[0])))
            port = self._replies({0}, self.timeout)[0]
            for r, conn in enumerate(self._conns[1:], 1):
                conn.send(dict(spec, rank=r, device=str(self.devices[r]),
                               port=port))
            info = self._replies(set(range(self.tensor_parallel)),
                                 self.timeout)
        except BaseException:
            self._kill()
            raise
        finally:
            listener.close()
        for name, value in info[0]["attrs"].items():
            setattr(self, name, value)
        self.arch = info[0]["arch"]
        self._spec = info[0]["kv_cache_spec"]
        self._watcher = threading.Thread(target=self._watch, daemon=True,
                                         name="tp-ranks-watch")
        self._watcher.start()
        atexit.register(self.close)
        logger.info("tensor-parallel group of %d ranks on %s ready",
                    self.tensor_parallel,
                    ", ".join(str(d) for d in self.devices))

    # ---- processes --------------------------------------------------------

    def _spawn(self, listener, key: bytes) -> None:
        """Start the rank processes and take their connections (each says
        which rank it is); fails when a rank exits before connecting."""
        import queue

        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        for r in range(self.tensor_parallel):
            # (an environment value holds no NUL: the name without it)
            env[_ENV] = f"{r}:{key.hex()}:{self._socket}"
            self._procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__], env=env, cwd=str(_ROOT)))
        accepted: "queue.Queue" = queue.Queue()

        def accept():
            try:
                for _ in range(self.tensor_parallel):
                    accepted.put(listener.accept())
            except OSError:          # the listener closed: we gave up
                pass

        threading.Thread(target=accept, daemon=True,
                         name="tp-ranks-accept").start()
        conns = {}
        deadline = time.monotonic() + self.timeout
        while len(conns) < self.tensor_parallel:
            codes = [p.poll() for p in self._procs]
            if any(c is not None for c in codes) \
                    or time.monotonic() > deadline:
                raise RankFailure(f"serving ranks did not connect (exit "
                                  f"codes {codes})")
            try:
                conn = accepted.get(timeout=0.2)
            except queue.Empty:
                continue
            _, rank = conn.recv()
            conns[int(rank)] = conn
        self._conns = [conns[r] for r in range(self.tensor_parallel)]

    def _kill(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.kill()
        for p in self._procs:
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                logger.error("serving rank %d did not exit", p.pid)

    def _watch(self) -> None:
        """Fail the group as soon as a rank process exits between calls."""
        while not self._closed and self._failure is None:
            codes = [p.poll() for p in self._procs]
            if any(c is not None for c in codes) and not self._closed:
                self._mark_failed(f"a rank exited (exit codes {codes})")
                return
            time.sleep(0.2)

    def _mark_failed(self, reason: str) -> RankFailure:
        with self._state:
            if self._failure is None:
                self._failure = RankFailure(
                    f"tensor-parallel serving group on "
                    f"{', '.join(str(d) for d in self.devices)}: {reason}")
                logger.error("%s", self._failure)
                self._kill()
                callbacks = list(self.on_failure)
            else:
                callbacks = []
            err = self._failure
        for cb in callbacks:
            try:
                cb(err)
            except Exception:  # noqa: BLE001 — every callback runs
                logger.exception("on_failure callback failed")
        return err

    def close(self, timeout: float = 60.0) -> None:
        """Stop the ranks (idempotent)."""
        with self._state:
            if self._closed:
                return
            self._closed = True
        if self._failure is None:
            for c in self._conns:
                try:
                    c.send(("close",))
                except OSError:
                    pass
            for p in self._procs:
                try:
                    p.wait(timeout)
                except subprocess.TimeoutExpired:
                    p.kill()
        self._kill()
        for c in self._conns:
            c.close()

    # ---- one exchange -----------------------------------------------------

    def _replies(self, ranks: set, timeout: float) -> dict:
        """Wait for one reply from each of ``ranks``; any other rank's
        socket that turns readable carries an error or an exit."""
        got: dict = {}
        rank_of = {id(c): r for r, c in enumerate(self._conns)}
        deadline = time.monotonic() + timeout
        while ranks - got.keys():
            left = deadline - time.monotonic()
            try:
                ready = wait(self._conns, timeout=left) if left > 0 else []
            except (OSError, ValueError) as e:
                raise self._mark_failed(f"lost the ranks: {e}") from None
            if not ready:
                raise self._mark_failed(f"no answer in {timeout:.0f} s")
            for conn in ready:
                r = rank_of[id(conn)]
                try:
                    kind, payload = conn.recv()
                    if kind == "logits":
                        payload = (payload, conn.recv_bytes())
                except (EOFError, OSError):
                    raise self._mark_failed(f"rank {r} exited") from None
                if kind == "error":
                    raise self._mark_failed(f"rank {r} raised:\n{payload}")
                if r not in ranks or r in got:
                    raise self._mark_failed(f"rank {r} answered {kind!r} "
                                            "out of turn")
                got[r] = payload
        return got

    def _call(self, msg: tuple, ranks=(0,)) -> dict:
        """Send ``msg`` to every rank; the replies of ``ranks``."""
        with self._lock:
            if self._failure is not None:
                raise self._failure
            if self._closed:
                raise RankFailure("the tensor-parallel group is closed")
            try:
                if self._dead:
                    dead = self._dead[:]
                    del self._dead[:len(dead)]
                    for c in self._conns:
                        c.send(("free", dead))
                for c in self._conns:
                    c.send(msg)
            except OSError as e:
                raise self._mark_failed(f"send failed: {e}") from None
            return self._replies(set(ranks), self.timeout)

    # ---- the model surface ------------------------------------------------

    def eval(self):
        return self

    def to(self, *args, **kw):
        return self

    def kv_cache_spec(self) -> dict:
        """Rank 0's spec: ``kv_heads`` is what each rank's pool holds."""
        return dict(self._spec)

    def _cache(self, paged: bool, layers=()) -> RemoteCache:
        cid = next(self._ids)
        cache = RemoteCache(cid, paged, list(layers))
        weakref.finalize(cache, self._dead.append, cid)
        return cache

    def new_cache(self, batch: int, total: int) -> RemoteCache:
        """A zeroed decode cache for a ``[batch, total]`` budget on every
        rank."""
        cache = self._cache(False)
        self._call(("new_cache", cache.cid, int(batch), int(total)),
                   ranks=())
        return cache

    def new_paged_cache(self, pool_blocks: int,
                        block_tokens: int) -> RemoteCache:
        """The KV block pool, each rank's pages at its own KV heads."""
        from ..models.llama import PagedLayer

        lead = (int(pool_blocks), int(block_tokens), self._spec["kv_heads"])
        kv = torch.int8 if self.kv_quant else self.dtype

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        layers = [PagedLayer(
            meta(lead + (self.head_dim,), kv), meta(lead + (self.head_dim,),
                                                    kv),
            *((meta(lead, torch.float32), meta(lead, torch.float32))
              if self.kv_quant else ()))
            for _ in range(self.n_layer)]
        cache = self._cache(True, layers)
        self._call(("new_pool", cache.cid, int(pool_blocks),
                    int(block_tokens)), ranks=())
        return cache

    def __call__(self, tokens, cache=None, prefill: bool = False,
                 block_tables=None, row_starts=None, pad_lens=None):
        return self.forward(tokens, cache, prefill, block_tables,
                            row_starts, pad_lens)

    def forward(self, tokens, cache=None, prefill: bool = False,
                block_tables=None, row_starts=None, pad_lens=None):
        """One model call on every rank (``LlamaLM.forward``'s cached
        arguments); returns the last position's f32 logits ``[B, 1, V]``
        on the CPU."""
        if not isinstance(cache, RemoteCache):
            raise ValueError("a tensor-parallel model call needs a cache "
                             "from its new_cache / new_paged_cache")
        if not cache.paged:
            if prefill and cache.pos_index != 0:
                raise ValueError("prefill=True needs a fresh cache "
                                 f"(pos_index is {cache.pos_index})")
            cache.pos_index += int(tokens.shape[1])
        t0 = time.perf_counter()
        got = self._call(("forward", cache.cid, bool(prefill),
                          *(_host(x) for x in (tokens, block_tables,
                                               row_starts, pad_lens))))
        self.round_trip_s += time.perf_counter() - t0
        shape, data = got[0]
        return torch.from_numpy(
            np.frombuffer(data, dtype=np.float32).reshape(shape).copy())

    def decode_probe(self, batch: int = 1) -> dict:
        """The ``parallel.collectives.P2P`` counts of one one-token decode
        step of ``batch`` rows on a scratch cache, counted on rank 0."""
        return self._call(("probe", int(batch)))[0]

    def rank_stats(self) -> list:
        """Every rank's record: device, parameter bytes, each pool's bytes
        (``{cid: bytes}``), peak device memory, kernel launches (B1, B4 and
        B4's arms), collective totals, model calls and the seconds spent
        in them (``busy_s``; ``split_s`` parts it into ``launch_s``, the
        forward's host time until it returns, ``wait_s``, rank 0 waiting
        for the device to finish the logits, and ``reply_s``, sending
        them), and the last :meth:`profile`'s summary, since the last
        :meth:`reset_counts`."""
        got = self._call(("stats",), ranks=range(self.tensor_parallel))
        return [got[r] for r in range(self.tensor_parallel)]

    def reset_counts(self) -> None:
        """Zero every rank's launch, collective and call counts, its time
        split and its peak memory, and :attr:`round_trip_s`."""
        self._call(("reset",), ranks=range(self.tensor_parallel))
        self.round_trip_s = 0.0

    def profile(self, skip: int, calls: int) -> None:
        """Trace rank 0's forward calls ``skip + 1 .. skip + calls`` from
        now with ``torch.profiler`` (host and device); the summary lands
        in its :meth:`rank_stats` ``profile``."""
        self._call(("profile", int(skip), int(calls)), ranks=())


# ---------------------------------------------------------------------------
# the rank process
# ---------------------------------------------------------------------------

def _trace_summary(prof, calls: int) -> dict:
    """Per traced call: the device's busy ms (every kernel and copy), the
    NCCL kernels' share of it, and the ten heaviest device and host
    entries ``[name, count, ms per call]``. Annotations (``nccl:
    all_reduce`` spans its kernel on the device) are left out, so nothing
    counts twice."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages() if not e.is_user_annotation]
    device = [e for e in rows if e.device_type != DeviceType.CPU]
    host = [e for e in rows if e.device_type == DeviceType.CPU]

    def ms(us):
        return us / 1e3 / calls

    def top(events, key):
        return [[e.key[:96], e.count, ms(key(e))]
                for e in sorted(events, key=key, reverse=True)[:10]]

    return {"calls": calls,
            "device_busy_ms": ms(sum(e.self_device_time_total
                                     for e in device)),
            "nccl_ms": ms(sum(e.self_device_time_total for e in device
                              if "nccl" in e.key.lower())),
            "top_device": top(device, lambda e: e.self_device_time_total),
            "top_host": top(host, lambda e: e.self_cpu_time_total)}


class _Rank:
    """One rank: its process group, its Megatron slice of the model and
    the caches the serving process made."""

    def __init__(self, spec: dict, conn):
        import torch.distributed as tdist

        from ..engine.serving import load_serving_model
        from .mesh import build_mesh

        self.rank = int(spec["rank"])
        self.device = torch.device(spec["device"])
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        else:
            torch.set_num_threads(1)
        world = int(spec["world"])
        # rank 0's store listens on a port the kernel picks (no window in
        # which another process can take it) and reports it
        store = tdist.TCPStore("127.0.0.1", int(spec.get("port", 0)), world,
                               is_master=self.rank == 0,
                               wait_for_workers=False)
        if self.rank == 0:
            conn.send(("port", store.port))
        tdist.init_process_group(
            "nccl" if self.device.type == "cuda" else "gloo", store=store,
            world_size=world, rank=self.rank)
        mesh = build_mesh({"tensor": int(spec["world"])})
        self.model = load_serving_model(spec["arch"], spec["resume"],
                                        self.device, mesh=mesh,
                                        verify=False)
        self.caches: dict = {}
        self.calls = 0
        self.busy_s = 0.0        # inside forward calls, reply included
        self.split = dict.fromkeys(("launch_s", "wait_s", "reply_s"), 0.0)
        self._trace = None       # rank 0's profiler while it runs
        self._trace_skip = self._trace_left = self._trace_n = 0
        self.profile = None      # the last trace's summary

    def info(self) -> dict:
        m = self.model
        return {"arch": type(m).__name__,
                "attrs": {k: getattr(m, k) for k in _ATTRS},
                "kv_cache_spec": m.kv_cache_spec(),
                "device": str(self.device),
                "param_bytes": sum(p.numel() * p.element_size()
                                   for p in m.parameters())}

    def _tensor(self, x, dtype):
        return None if x is None else torch.from_numpy(x).to(
            self.device, dtype)

    def forward(self, cid, prefill, tokens, tables, starts, pads):
        logits = self.model(
            self._tensor(tokens, torch.long), cache=self.caches[cid],
            prefill=prefill, block_tables=self._tensor(tables, torch.int32),
            row_starts=self._tensor(starts, torch.int32),
            pad_lens=self._tensor(pads, torch.int32))
        self.calls += 1
        return logits[:, -1:]

    def probe(self, batch: int) -> dict:
        from . import collectives

        cache = self.model.new_cache(batch, 2)
        tok = torch.zeros((batch, 1), dtype=torch.long, device=self.device)
        self.model(tok, cache=cache, prefill=True)
        before = dict(collectives.P2P)
        self.model(tok, cache=cache)
        return {k: collectives.P2P[k] - before[k] for k in before}

    def _tracing(self, before: bool) -> None:
        """Start rank 0's profiler before the first traced forward call;
        stop it after the last and keep its summary."""
        if before:
            if self._trace_left and self._trace is None:
                if self._trace_skip:
                    self._trace_skip -= 1
                    return
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                                 if self.device.type
                                                 == "cuda" else [])
                self._trace = profile(activities=acts)
                self._trace.__enter__()
            return
        if self._trace is None:
            return
        self._trace_left -= 1
        if self._trace_left == 0:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._trace.__exit__(None, None, None)
            self.profile = _trace_summary(self._trace, self._trace_n)
            self._trace = None

    def stats(self) -> dict:
        from ..models.llama import PagedCache
        from ..ops import flash
        from . import collectives

        def nbytes(cache):
            return sum(t.numel() * t.element_size()
                       for layer in cache.layers
                       for t in vars(layer).values()
                       if isinstance(t, torch.Tensor))

        cuda = self.device.type == "cuda"
        return {"rank": self.rank, "device": str(self.device),
                "param_bytes": self.info()["param_bytes"],
                "pool_bytes": {cid: nbytes(c)
                               for cid, c in self.caches.items()
                               if isinstance(c, PagedCache)},
                "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                               if cuda else 0),
                "launches": {"flash_fwd": flash.FLASH_FWD.launches,
                             "paged_attn": flash.PAGED_ATTN.launches},
                "paged_arms": dict(flash.PAGED_ARM_LAUNCHES),
                "p2p": dict(collectives.P2P), "calls": self.calls,
                "busy_s": self.busy_s, "split_s": dict(self.split),
                "profile": self.profile}

    def reset(self) -> None:
        from ..ops import flash
        from . import collectives

        flash.FLASH_FWD.reset()
        flash.PAGED_ATTN.reset()
        with flash.COUNT_LOCK:
            for arm in flash.PAGED_ARM_LAUNCHES:
                flash.PAGED_ARM_LAUNCHES[arm] = 0
        collectives.reset_counts()
        self.calls, self.busy_s = 0, 0.0
        self.split = dict.fromkeys(self.split, 0.0)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    @torch.inference_mode()
    def serve(self, conn) -> None:
        """Run the serving process's calls until it says ``close`` or goes
        away."""
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                return
            kind = msg[0]
            if kind == "close":
                return
            if kind == "free":
                for cid in msg[1]:
                    self.caches.pop(cid, None)
            elif kind == "new_cache":
                self.caches[msg[1]] = self.model.new_cache(msg[2], msg[3])
            elif kind == "new_pool":
                self.caches[msg[1]] = self.model.new_paged_cache(msg[2],
                                                                 msg[3])
            elif kind == "forward":
                self._tracing(before=True)
                t0 = time.perf_counter()
                out = self.forward(*msg[1:])
                t1 = t2 = t3 = time.perf_counter()
                if self.rank == 0:
                    arr = np.ascontiguousarray(out.float().cpu().numpy())
                    t2 = time.perf_counter()
                    conn.send(("logits", arr.shape))
                    conn.send_bytes(arr)
                    t3 = time.perf_counter()
                self.busy_s += t3 - t0
                for key, dt in (("launch_s", t1 - t0), ("wait_s", t2 - t1),
                                ("reply_s", t3 - t2)):
                    self.split[key] += dt
                self._tracing(before=False)
            elif kind == "profile":
                if self.rank == 0:
                    self._trace_skip, self._trace_left = msg[1], msg[2]
                    self._trace_n = msg[2]
            elif kind == "probe":
                out = self.probe(msg[1])
                if self.rank == 0:
                    conn.send(("probe", out))
            elif kind == "stats":
                conn.send(("stats", self.stats()))
            elif kind == "reset":
                self.reset()
                conn.send(("reset", None))
            else:
                raise ValueError(f"unknown serving-rank call {kind!r}")


def main() -> int:
    """A rank process: connect back to the serving process named in the
    environment, load this rank's slice, serve its calls."""
    rank, key, name = os.environ[_ENV].split(":", 2)
    conn = Client("\0" + name, family="AF_UNIX", authkey=bytes.fromhex(key))
    conn.send(("hello", int(rank)))
    try:
        spec = conn.recv()
        runner = _Rank(spec, conn)
        conn.send(("ready", runner.info()))
        runner.serve(conn)
    except EOFError:
        return 0
    except BaseException:  # noqa: BLE001 — reported, then the rank exits
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
        # the group's collectives are in an unknown state: leave without
        # tearing the process group down (it may block on a dead peer)
        os._exit(1)
    import torch.distributed as tdist

    if tdist.is_initialized():
        tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.WARNING,
                        format="%(asctime)s serving-rank %(message)s")
    sys.exit(main())
