"""The port's HTTP front end (``pytorch_distributed_template_tpu_torch/
serve.py``) driven in-process on the CPU: ``main`` runs in a thread on a
free port over a tiny artifact made by the port's tool, and the tests talk
HTTP to it.

- ``POST /generate`` plain, and with ``"stream": true`` (server-sent
  events whose deltas concatenate to the final ids), served by the
  continuous engine over the paged pool, equal to the solo service;
- ``GET /healthz`` and ``GET /metrics?format=json`` (engine stats + pool
  snapshot);
- a bad request is a 400; the static scheduler and page shipping are
  refused, naming the later slice.
"""
import json
import threading
import urllib.error
import urllib.request

import pytest

from pytorch_distributed_template_tpu_torch import serve
from pytorch_distributed_template_tpu_torch.engine.serving import (
    GenerationService,
)
from pytorch_distributed_template_tpu_torch.tools import (
    make_serving_artifact as tool,
)

PROMPT = list(range(3, 40))


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    tool.main(["-o", str(tmp / "art"), "--arch", "TinyLlama", "--seed", "2",
               "--device", "cpu"])
    ready = threading.Event()
    box = {}

    def on_ready(srv, svc):
        box.update(server=srv, service=svc)
        ready.set()

    argv = ["-r", str(tmp / "art" / "model"), "-s", str(tmp / "run"),
            "--port", "0", "--device", "cpu", "--prefix-cache", "on",
            "--max-batch", "2", "--decode-chunk", "4",
            "--batch-window-ms", "5"]
    thread = threading.Thread(target=serve.main, args=(argv, on_ready),
                              daemon=True)
    thread.start()
    assert ready.wait(120), "serve.main never became ready"
    host, port = box["server"].server_address[:2]
    box["url"] = f"http://{host}:{port}"
    yield box
    box["server"].shutdown()
    thread.join(60)
    assert not thread.is_alive()


def _post(url, body, timeout=60):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.loads(r.read())


def test_generate_plain_and_streamed(server):
    svc = server["service"]
    assert type(svc).__name__ == "ContinuousBatchingService"
    solo = GenerationService.from_model(svc.model, device="cpu")
    want = solo.generate(prompt_ids=PROMPT, max_new_tokens=10)["ids"]
    code, body = _post(server["url"], {"prompt_ids": PROMPT,
                                       "max_new_tokens": 10})
    assert code == 200 and json.loads(body)["ids"] == want
    code, body = _post(server["url"], {"prompt_ids": PROMPT,
                                       "max_new_tokens": 10,
                                       "stream": True})
    events = [json.loads(line[len("data: "):])
              for line in body.splitlines() if line.startswith("data: ")]
    assert code == 200 and events[-1]["done"] is True
    deltas = [i for e in events[:-1] for i in e["ids"]]
    assert deltas == events[-1]["ids"] == want


def test_healthz_and_metrics(server):
    _post(server["url"], {"prompt_ids": PROMPT, "max_new_tokens": 4})
    health = _get(server["url"], "/healthz")
    assert health["status"] == "ok"
    assert health["scheduler"] == "ContinuousBatchingService"
    assert health["device"] == "cpu"
    metrics = _get(server["url"], "/metrics?format=json")
    assert metrics["stats"]["paged_chunks"] == metrics["stats"]["chunks"]
    assert metrics["stats"]["completed"] >= 1
    pool = metrics["prefix_cache"]
    assert pool["warm_admit_copy_bytes"] == 0
    assert pool["prefix_hit_tokens"] > 0
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server["url"] + "/metrics", timeout=60)
    assert e.value.code == 501


def test_bad_and_later_slice_requests(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server["url"], {"prompt_ids": [1, 2], "max_new_tokens": 0})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server["url"], {"prompt_ids": [1, 2], "stream": True,
                              "max_new_tokens": 999})
    assert e.value.code == 400
    req = urllib.request.Request(server["url"] + "/prefill", data=b"{}",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 501
    assert "later slice" in json.loads(e.value.read())["error"]


@pytest.mark.parametrize("flags", [
    ["--scheduler", "static"], ["--tp", "2"], ["--dp", "2"],
    ["--role", "decode"], ["--spill-blocks", "8"],
])
def test_later_slice_flags_are_refused_by_name(flags):
    args = serve.build_parser().parse_args(["-r", "unused", "--device",
                                            "cpu"] + flags)
    with pytest.raises(NotImplementedError, match="later slice"):
        serve.build_service(args, None)
