"""Serve the detector over REST or gRPC: the ``serve`` subcommand of
``scripts/deploy.py``, with its flags, on the port's ``InferenceEngine``.

    python -m hvs_tpu_torch.deploy serve --backend rest --port 8000
    python -m hvs_tpu_torch.deploy serve --backend grpc --port 50051
    python -m hvs_tpu_torch.deploy serve --backend rest --device cpu --tiny

Runs on the card unless ``--device cpu`` is given; ``--tiny`` serves the
export tool's tiny model (smoke runs). The reference's ``docker``, ``k8s``,
``cloud`` and ``edge`` subcommands are not ported.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Deploy the vision stack (PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="action", required=True)
    s = sub.add_parser("serve")
    s.add_argument("--backend", choices=["rest", "grpc"], default="rest")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--checkpoint", default=None)
    s.add_argument("--device", default=None, help="cuda (default) or cpu")
    s.add_argument("--tiny", action="store_true", help="tiny model at 64² (smoke runs)")
    return p.parse_args(argv)


def build_engine(args):
    from .config import InferenceConfig, ModelConfig
    from .export_model import tiny_configs
    from .inference import InferenceEngine

    device = args.device or "auto"
    mcfg = ModelConfig(device=device)
    icfg = InferenceConfig(device=device)
    if args.checkpoint:
        icfg.checkpoint_path = args.checkpoint
    if args.tiny:
        tiny_configs(mcfg, icfg, icfg.preprocessing.image_size)
    return InferenceEngine(mcfg, icfg)


def serve(args) -> None:
    engine = build_engine(args)
    if args.backend == "rest":
        from .deployment.api_server import run_server

        run_server(engine, host=args.host, port=args.port)
    else:
        from .deployment.grpc_server import RobotGRPCServer

        server = RobotGRPCServer(engine, host=args.host, port=args.port)
        server.start()
        print(f"gRPC serving on {args.host}:{args.port}", flush=True)
        server.wait()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.action == "serve":
        serve(args)


if __name__ == "__main__":
    main()
