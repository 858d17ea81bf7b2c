"""The port's serve.py on the CPU: the SIGTERM drain (the JAX ``serve.py``'s
preemption path) and ``--ema``.

- a server process answers a request that is in flight when SIGTERM comes,
  then exits with code 75 (``EXIT_PREEMPTED``);
- ``--ema`` serves a training checkpoint's EMA weights (``ema.pt`` over
  ``model.pt``), the plain flag its ``model.pt``.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import torch

from pytorch_distributed_template_tpu_torch import serve
from pytorch_distributed_template_tpu_torch.checkpoint.manager import EMA_FILE
from pytorch_distributed_template_tpu_torch.config import ConfigParser
from pytorch_distributed_template_tpu_torch.config.registry import MODELS
from pytorch_distributed_template_tpu_torch.tools import (
    make_serving_artifact as tool,
)
from pytorch_distributed_template_tpu_torch.utils.preemption import (
    EXIT_PREEMPTED,
)

REPO = Path(__file__).resolve().parent.parent


def test_sigterm_drains_in_flight_requests_and_exits_75(tmp_path):
    tool.main(["-o", str(tmp_path / "art"), "--arch", "TinyLlama",
               "--seed", "2", "--device", "cpu"])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_template_tpu_torch.serve",
         "-r", str(tmp_path / "art" / "model"), "-s", str(tmp_path / "run"),
         "--port", "0", "--device", "cpu", "--prefix-cache", "on",
         "--max-batch", "2", "--decode-chunk", "1", "--drain-grace-s", "60"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        url = None
        for line in proc.stdout:
            if line.startswith("READY "):
                url = line.split()[1]
                break
        assert url, "the server never became ready"
        first, box = threading.Event(), {}

        def stream():
            body = json.dumps({"prompt_ids": list(range(3, 12)),
                               "max_new_tokens": 96, "stream": True})
            req = urllib.request.Request(url + "/generate",
                                         data=body.encode(), method="POST")
            events = []
            with urllib.request.urlopen(req, timeout=120) as r:
                for raw in r:
                    if raw.startswith(b"data: "):
                        events.append(json.loads(raw[6:]))
                        first.set()
            box["events"] = events

        th = threading.Thread(target=stream, daemon=True)
        th.start()
        assert first.wait(60), "no token before the signal"
        proc.send_signal(signal.SIGTERM)
        th.join(120)
        final = box["events"][-1]
        assert final["done"] and len(final["ids"]) == 96
        assert proc.wait(120) == EXIT_PREEMPTED
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)


def test_ema_flag_serves_the_ema_weights(tmp_path):
    arch = {"type": "TinyLlama", "args": {}}
    run = tmp_path / "run"
    (run / "checkpoint").mkdir(parents=True)
    (run / "config.json").write_text(json.dumps({
        "name": "ema", "arch": arch, "trainer": {"save_dir": str(tmp_path)}}))
    model = MODELS.get("TinyLlama")(device="cpu")
    model.init_weights(torch.Generator().manual_seed(3))
    state = model.state_dict()
    torch.save(state, run / "checkpoint" / "model.pt")
    name = "lm_head.weight"
    ema = {name: state[name] + 1.0}
    torch.save(ema, run / "checkpoint" / EMA_FILE)
    for flags, want in (([], state[name]), (["--ema"], ema[name])):
        args, config = ConfigParser.from_args(
            serve.build_parser(), (), training=False,
            argv=["-r", str(run / "checkpoint"), "--device", "cpu",
                  "--scheduler", "none", "-s", str(tmp_path / "s")] + flags)
        svc = serve.build_service(args, config)
        assert torch.equal(svc.model.state_dict()[name], want)
