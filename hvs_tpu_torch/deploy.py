"""The deploy tool: container images, Kubernetes, cloud bundles, edge hosts,
and the REST or gRPC server, for NVIDIA H100 hosts.

    python -m hvs_tpu_torch.deploy docker --tag hvs-gpu-inference:v1 --dry-run
    python -m hvs_tpu_torch.deploy k8s --namespace hvs-gpu --dry-run
    python -m hvs_tpu_torch.deploy cloud --provider gke-gpu --out-dir cloud_bundles
    python -m hvs_tpu_torch.deploy edge --host robot-01 --dry-run
    python -m hvs_tpu_torch.deploy serve --backend rest --port 8000
    python -m hvs_tpu_torch.deploy serve --backend rest --device cpu --tiny

``docker``, ``k8s`` and ``edge`` run ``docker``, ``kubectl``, ``ssh`` and
``scp``; with ``--dry-run`` they print the exact commands and run none.
``cloud`` writes a provider's bundle (``deployment/cloud_codegen.py``).
``edge`` first reads the target's compute capability and stops unless it is
9.0: the kernels are built for ``sm_90a`` alone. Defaults come from
``deployment/defaults.yaml`` (or ``--config``), under the flags given.

``serve`` runs on the card unless ``--device cpu`` is given; ``--tiny``
serves the export tool's tiny model (smoke runs); ``--image-size`` sets the
letterbox size (default: ``InferenceConfig``'s). The container image is
built and pushed with ``docker``, outside this tool's tests; its files are in
``deployment/container/`` and the cluster's in ``deployment/kubernetes/``.
"""

from __future__ import annotations

import argparse
import math
import os
import shlex
import subprocess
import sys
from typing import List, Optional, Sequence

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
DEPLOYMENT_DIR = os.path.join(PACKAGE_DIR, "deployment")
DEFAULTS = os.path.join(DEPLOYMENT_DIR, "defaults.yaml")
DEPLOYMENT_NAME = "hvs-gpu-inference"
REQUIRED_COMPUTE_CAP = "9.0"
# Applied first: the priority classes the Deployment names, then what it reads.
K8S_FIRST = ("gpu-scheduler.yaml", "configmap.yaml", "secrets.yaml")


def _in_repo(path: str) -> str:
    """``path`` as given when it exists or is absolute, else under the
    repository root (so the defaults work from any directory)."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    return os.path.join(REPO_ROOT, path)


class DeploymentManager:
    """Runs (or, with ``dry_run``, prints) the commands of each subcommand."""

    def __init__(self, dry_run: bool = False):
        self.dry_run = dry_run
        self.executed: List[str] = []

    def _run(self, cmd: list, capture: bool = False):
        printable = " ".join(shlex.quote(c) for c in cmd)
        self.executed.append(printable)
        print(f"$ {printable}", flush=True)
        if self.dry_run:
            return (0, "") if capture else 0
        if capture:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            return proc.returncode, proc.stdout
        return subprocess.run(cmd).returncode

    def docker_build(self, tag: str, dockerfile: str, push: bool = False,
                     registry: str = "") -> int:
        rc = self._run(["docker", "build", "-f", _in_repo(dockerfile), "-t", tag, REPO_ROOT])
        if rc == 0 and push:
            full = f"{registry}/{tag}" if registry else tag
            if registry:
                rc = self._run(["docker", "tag", tag, full])
            rc = rc or self._run(["docker", "push", full])
        return rc

    def k8s_apply(self, manifest_dir: str, namespace: str = "hvs-gpu") -> int:
        from .deployment.cloud_codegen import MEASURED_STARTUP_S, STARTUP_ALLOWANCE

        manifest_dir = _in_repo(manifest_dir)
        names = sorted(n for n in os.listdir(manifest_dir) if n.endswith((".yaml", ".yml")))
        names = [n for n in K8S_FIRST if n in names] + [n for n in names if n not in K8S_FIRST]
        rc = self._run(["kubectl", "get", "namespace", namespace])
        if rc != 0:
            rc = self._run(["kubectl", "create", "namespace", namespace])
        for name in names:
            rc = rc or self._run(["kubectl", "apply", "-n", namespace, "-f",
                                  os.path.join(manifest_dir, name)])
        # The probes' startup allowance for each of up to 10 pods, one surge at a time.
        timeout_s = math.ceil(10 * STARTUP_ALLOWANCE * MEASURED_STARTUP_S)
        return rc or self._run(["kubectl", "rollout", "status", "-n", namespace,
                                f"deployment/{DEPLOYMENT_NAME}", f"--timeout={timeout_s}s"])

    def generate_cloud_manifest(self, provider: str, out_dir: str,
                                image: str = "hvs-gpu-inference:latest",
                                registry: str = "") -> list:
        """The provider's bundle under ``out_dir/<provider>``
        (``deployment/cloud_codegen.py``)."""
        from .deployment.cloud_codegen import CloudDeployConfig, generate

        files = generate(provider, out_dir, CloudDeployConfig(image=image, registry=registry))
        for f in files:
            print(f"wrote {f}")
        return files

    def edge_deploy(self, host: str, user: str = "robot",
                    remote_dir: str = "/srv/hvs_gpu") -> int:
        """Check the target's card, copy the package, start the camera loop."""
        target = f"{user}@{host}"
        rc, out = self._run(["ssh", target, "nvidia-smi", "--query-gpu=compute_cap",
                             "--format=csv,noheader"], capture=True)
        caps = [line.strip() for line in out.splitlines() if line.strip()]
        if rc != 0 or (not self.dry_run and (not caps or any(c != REQUIRED_COMPUTE_CAP
                                                               for c in caps))):
            print(f"edge: {host} reads compute capability {caps or 'none'} (nvidia-smi exit "
                  f"{rc}); the kernels are built for sm_90a and need {REQUIRED_COMPUTE_CAP}",
                  file=sys.stderr)
            return rc or 1
        rc = self._run(["ssh", target, f"mkdir -p {remote_dir}"])
        rc = rc or self._run(["scp", "-r", PACKAGE_DIR, f"{target}:{remote_dir}/"])
        return rc or self._run(["ssh", target, f"cd {remote_dir} && python -m "
                                "hvs_tpu_torch.infer --source 0"])


def apply_config_defaults(args, subparser, path, argv=None):
    """Overlay the YAML file's section for ``args.action`` under the flags.

    Precedence: a flag given on the command line > the YAML value > the
    argparse default. A flag counts as given when it appears in ``argv``, not
    when its value differs from the default. A relative ``path`` that does
    not exist is looked up in the package's ``deployment/`` directory.
    """
    if path and not os.path.isabs(path) and not os.path.exists(path):
        candidate = os.path.join(DEPLOYMENT_DIR, path)
        if os.path.exists(candidate):
            path = candidate
    if not path or not os.path.exists(path):
        return args
    import yaml

    argv = list(sys.argv[1:] if argv is None else argv)
    explicit = set()
    for action in subparser._actions:
        for opt in action.option_strings:
            if any(tok == opt or tok.startswith(opt + "=") for tok in argv):
                explicit.add(action.dest)
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    for key, value in (cfg.get(args.action) or {}).items():
        attr = key.replace("-", "_")
        if hasattr(args, attr) and attr not in explicit:
            setattr(args, attr, value)
    return args


def build_parser():
    p = argparse.ArgumentParser(description="Deploy the vision stack (PyTorch/CUDA port)")
    p.add_argument("--config", default=DEFAULTS, help="YAML defaults under the flags")
    sub = p.add_subparsers(dest="action", required=True)

    d = sub.add_parser("docker")
    d.add_argument("--tag", default="hvs-gpu-inference:latest")
    d.add_argument("--dockerfile",
                   default="hvs_tpu_torch/deployment/container/Dockerfile.inference")
    d.add_argument("--push", action="store_true")
    d.add_argument("--registry", default="")
    d.add_argument("--dry-run", action="store_true")

    k = sub.add_parser("k8s")
    k.add_argument("--manifest-dir", default="hvs_tpu_torch/deployment/kubernetes")
    k.add_argument("--namespace", default="hvs-gpu")
    k.add_argument("--dry-run", action="store_true")

    c = sub.add_parser("cloud")
    from .deployment.cloud_codegen import PROVIDERS

    c.add_argument("--provider", default="gke-gpu", choices=sorted(PROVIDERS))
    c.add_argument("--out-dir", default="cloud_bundles")
    c.add_argument("--image", default="hvs-gpu-inference:latest")
    c.add_argument("--registry", default="")

    e = sub.add_parser("edge")
    e.add_argument("--host", required=True)
    e.add_argument("--user", default="robot")
    e.add_argument("--remote-dir", default="/srv/hvs_gpu")
    e.add_argument("--dry-run", action="store_true")

    s = sub.add_parser("serve")
    s.add_argument("--backend", choices=["rest", "grpc"], default="rest")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--checkpoint", default=None)
    s.add_argument("--device", default=None, help="cuda (default) or cpu")
    s.add_argument("--tiny", action="store_true", help="tiny model at 64² (smoke runs)")
    s.add_argument("--image-size", type=int, default=None,
                   help="letterbox size (default: InferenceConfig's)")
    return p, sub


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p, sub = build_parser()
    args = p.parse_args(argv)
    return apply_config_defaults(args, sub.choices[args.action], args.config, argv)


def build_engine(args):
    from .config import InferenceConfig, ModelConfig
    from .export_model import tiny_configs
    from .inference import InferenceEngine

    device = args.device or "auto"
    mcfg = ModelConfig(device=device)
    icfg = InferenceConfig(device=device)
    if args.checkpoint:
        icfg.checkpoint_path = args.checkpoint
    if getattr(args, "image_size", None):
        icfg.preprocessing.image_size = args.image_size
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


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.action == "docker":
        return DeploymentManager(args.dry_run).docker_build(
            args.tag, args.dockerfile, args.push, args.registry)
    if args.action == "k8s":
        return DeploymentManager(args.dry_run).k8s_apply(args.manifest_dir, args.namespace)
    if args.action == "cloud":
        DeploymentManager().generate_cloud_manifest(args.provider, args.out_dir,
                                                    image=args.image, registry=args.registry)
        return 0
    if args.action == "edge":
        return DeploymentManager(args.dry_run).edge_deploy(args.host, args.user,
                                                           args.remote_dir)
    serve(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
