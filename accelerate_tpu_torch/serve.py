"""``python -m accelerate_tpu_torch.serve`` — run the OpenAI-compatible front door.

Port of :mod:`accelerate_tpu.serve`: one command that builds N engine
replicas on the card, puts the elastic
:class:`~accelerate_tpu_torch.serving.router.ReplicaRouter` behind the
:class:`~accelerate_tpu_torch.serving.api.FrontDoor` driver, and binds the
HTTP edge (:class:`~accelerate_tpu_torch.serving.api.ApiServer`):
completions, chat, SSE streaming, and the telemetry surface on one port.

Examples::

    # a tiny random-weight model on the card (smoke test)
    python -m accelerate_tpu_torch.serve --preset tiny --port 8000

    # two paged replicas from a save_model export, bounded queues
    python -m accelerate_tpu_torch.serve --preset small \
        --checkpoint /ckpts/step-9000 --replicas 2 --paged \
        --max-queue 64 --weights-version step-9000 --port 8000

    curl -N localhost:8000/v1/completions -d \
        '{"prompt": [3, 1, 4, 1, 5], "max_tokens": 8, "stream": true, \
          "temperature": 0}'

Each replica holds its own copy of the weights (a model and state dict of
its own), so that :meth:`ReplicaRouter.hot_swap` can copy new weights into
one replica while the others serve the old ones.  Weight hot-swap and
replica drain are driver operations, not CLI flags.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Union

import torch

__all__ = ["build_service", "main"]


def _build_params(cfg, seed: int, checkpoint: Optional[str], device: torch.device):
    """The served weights on ``device``: a ``save_model`` export, else random
    ones from ``seed`` in the config's parameter dtype."""
    if checkpoint:
        from .checkpointing import load_model_params

        return {k: v.to(device) for k, v in load_model_params(checkpoint).items()}
    from .weights import init_params

    return init_params(cfg, seed=seed, device=device, dtype=cfg.param_dtype)


def build_service(args, device: Optional[Union[str, torch.device]] = None):
    """Construct (router, frontdoor, server) from parsed CLI args, on the
    card unless ``device`` says otherwise (tests pass ``"cpu"``).  Split
    from :func:`main` so tests and benches can assemble the exact service
    the CLI would, minus the blocking serve loop."""
    from ._device import resolve_device
    from .models.transformer import Transformer, TransformerConfig
    from .serving import ReplicaRouter, ServingEngine
    from .serving.api import ApiServer, FrontDoor

    presets = {
        "tiny": TransformerConfig.tiny,
        "gpt2-xl": TransformerConfig.gpt2_xl_equiv,
        "small": lambda **kw: TransformerConfig(
            vocab_size=32000, hidden_size=1024, intermediate_size=4096,
            num_layers=12, num_heads=16, num_kv_heads=16, max_seq_len=512,
            **kw,
        ),
    }
    if args.preset not in presets:
        raise SystemExit(
            f"unknown --preset {args.preset!r}; choose from {sorted(presets)}"
        )
    device = resolve_device(device)
    cfg = presets[args.preset](max_seq_len=args.max_len)
    params = _build_params(cfg, args.seed, args.checkpoint, device)

    engines = []
    for i in range(args.replicas):
        # each replica its own model and its own copy of the weights
        own = params if i == 0 else {k: v.clone() for k, v in params.items()}
        engines.append(ServingEngine(
            Transformer(cfg, device="meta"), own,
            num_slots=args.num_slots,
            max_len=args.max_len,
            decode_window=args.decode_window,
            paged=args.paged,
            speculate_k=args.speculate_k,
            max_queue=args.max_queue,
            weights_version=args.weights_version,
            rng_seed=args.seed + i,
            device=device,
        ))
    router = ReplicaRouter(engines, policy=args.policy)
    frontdoor = FrontDoor(router, model_name=args.model_name).start()
    server = ApiServer(
        frontdoor,
        host=args.host,
        port=args.port,
        unhealthy_after_s=args.unhealthy_after_s,
        request_timeout_s=args.request_timeout_s,
    )
    return router, frontdoor, server


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.serve",
        description="OpenAI-compatible serving front door for accelerate_tpu_torch",
    )
    p.add_argument("--preset", default="tiny",
                   help="model geometry: tiny | small | gpt2-xl")
    p.add_argument("--checkpoint", default=None,
                   help="safetensors directory (save_model export); random "
                        "init when omitted")
    p.add_argument("--model-name", default="accelerate-tpu",
                   help="model id served by /v1/models")
    p.add_argument("--weights-version", default="v0",
                   help="weights label for /v1/models and A/B pinning")
    p.add_argument("--host", default=None,
                   help="bind host (default ATPU_API_HOST or 127.0.0.1)")
    p.add_argument("--port", type=int, default=8000,
                   help="bind port (0 = ephemeral)")
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--policy", default="affinity",
                   choices=("affinity", "round_robin"))
    p.add_argument("--num-slots", type=int, default=4)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--decode-window", type=int, default=4)
    p.add_argument("--paged", action="store_true",
                   help="paged KV pool (the kernels' path) instead of per-slot slabs")
    p.add_argument("--speculate-k", type=int, default=0)
    p.add_argument("--max-queue", type=int, default=256,
                   help="per-replica admission bound (queue-full -> 429); "
                        "0 = unbounded")
    p.add_argument("--unhealthy-after-s", type=float, default=60.0)
    p.add_argument("--request-timeout-s", type=float, default=600.0)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.max_queue == 0:
        args.max_queue = None
    router, frontdoor, server = build_service(args)
    print(f"serving {args.model_name} ({args.preset}, "
          f"{args.replicas} replica(s), version {args.weights_version}) "
          f"on {server.url}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("shutting down", flush=True)
    finally:
        server.stop()
        frontdoor.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
