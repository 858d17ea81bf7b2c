"""Sampling CLI of the port: generate continuations from a serving
artifact (a w8a16 one from tools/quantize_checkpoint.py included) or a
training checkpoint, the counterpart of the repository's root
``generate.py``.

    python -m pytorch_distributed_template_tpu_torch.generate \\
        -r <artifact>/model --prompt-ids 1,2,3 --max-new-tokens 32

Runs on CUDA unless ``--device cpu`` is given; ``--tp T`` serves the model
over T cards (T rank processes this command starts and stops:
parallel/serving_ranks.py). ``--prompt`` treats the
text as UTF-8 bytes for byte-vocab models (vocab <= 256) or encodes it
with the run's BPE tokenizer; ``--prompt-ids`` takes comma-separated ids,
and ids are printed back. ``--speculative D`` serves the request by
prompt-lookup speculative decoding (engine/generate.py) and logs its
acceptance stats; ``--set "arch;args;kv_quant" int8`` stores the decode
cache int8.
"""
from __future__ import annotations

import argparse
import json

from .config import ConfigParser
from .engine.serving import GenerationService
from . import models  # noqa: F401  (registers the model families)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="LM sampling CLI (PyTorch)")
    parser.add_argument("-c", "--config", default=None, type=str,
                        help="Optional config overlay (fine-tune style).")
    parser.add_argument("-r", "--resume", required=True, type=str,
                        help="Serving artifact to sample from.")
    parser.add_argument("-s", "--save_dir", default=None, type=str)
    prompt_group = parser.add_mutually_exclusive_group()
    prompt_group.add_argument("--prompt", default=None, type=str,
                              help="Text prompt.")
    prompt_group.add_argument("--prompt-ids", default=None, type=str,
                              help="Comma-separated token ids.")
    parser.add_argument("--max-new-tokens", default=64, type=int)
    parser.add_argument("--temperature", default=0.0, type=float,
                        help="<= 0 means greedy.")
    parser.add_argument("--top-k", default=0, type=int)
    parser.add_argument("--top-p", default=0.0, type=float)
    parser.add_argument("--ema", action="store_true",
                        help="Sample EMA weights (moot for artifacts).")
    parser.add_argument("--speculative", default=0, type=int, metavar="D",
                        help="Prompt-lookup speculative decoding with D "
                             "draft tokens per verify call (greedy output "
                             "is unchanged; batch 1).")
    parser.add_argument("--stop", action="append", default=None,
                        metavar="STR",
                        help="Stop STRING (must encode to one token); "
                             "repeatable.")
    parser.add_argument("--stop-id", action="append", default=None,
                        metavar="ID", help="Stop token ID; repeatable.")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--tp", default=0, type=int,
                        help="Tensor-parallel degree: one rank process per "
                             "card (0 = the config's "
                             "serving.tensor_parallel, else 1).")
    parser.add_argument("--device", default=None,
                        help="Device to run on (default cuda).")
    return parser


def main(argv=None) -> dict:
    """Parse ``argv`` (default ``sys.argv``), serve one request, print the
    continuation and return the response."""
    args, config = ConfigParser.from_args(build_parser(), (),
                                          training=False, argv=argv)
    logger = config.get_logger("generate")
    service = GenerationService(config, device=args.device,
                                use_ema=args.ema, tensor_parallel=args.tp)
    prompt_ids = ([int(x) for x in args.prompt_ids.split(",")]
                  if args.prompt_ids else None)
    stop = None
    if args.stop or args.stop_id:
        stop = list(args.stop or []) + [int(i) for i in
                                        (args.stop_id or [])]
    try:
        resp = service.generate(
            prompt=args.prompt, prompt_ids=prompt_ids,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, seed=args.seed,
            speculative=args.speculative, stop=stop)
    except ValueError as e:
        raise SystemExit(str(e))
    finally:
        service.close()
    if stop is not None:
        logger.info("stop_reason: %s", resp.get("stop_reason"))
    if resp.get("speculative"):
        logger.info("speculative: %s", json.dumps(resp["speculative"]))
    if args.prompt is not None:
        logger.info("prompt   : %s", args.prompt)
        logger.info("generated: %s", resp.get("text"))
        print(args.prompt + (resp.get("text") or ""))
    else:
        print(",".join(str(t) for t in resp["ids"]))
    return resp


if __name__ == "__main__":
    main()
