"""Cloud deployment bundles for the port's serving image on NVIDIA H100 hosts.

``generate(provider, out_dir, cfg)`` writes one self-contained directory per
provider: manifests, an executable ``deploy.sh`` and, where the provider
deploys through its SDK, a Python script. Every target serves the port's
image (``container/Dockerfile.inference``): the package with its kernels
built for ``sm_90a`` at image build, run by ``entrypoint.sh``. The kernels
launch on a compute-capability-9.0 card alone, so every target names an H100
machine, and every Kubernetes pod asks for one ``nvidia.com/gpu`` on an H100
node.

Providers:
  gke-gpu     GKE: Deployment, Service, HPA, PodMonitoring, deploy.sh (an
              H100 node pool, one card per pod, a startup probe sized from
              the measured startup)
  vertex-gpu  a Vertex AI endpoint on ``a3-highgpu-1g`` with one H100
  gpu-vm      a Compute Engine VM with one H100 and a systemd unit
  sagemaker   a SageMaker endpoint on an H100 instance (the container's
              ``serve`` mode: ``/ping`` and ``/invocations`` on port 8080)
  azureml     an AzureML managed online endpoint on ``Standard_NC40ads_H100_v5``

Nothing here builds or pushes an image or talks to a cloud: the bundles are
text, and their ``deploy.sh`` runs the provider's CLI where it is installed.
"""

from __future__ import annotations

import json
import math
import os
import textwrap
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# The serving container's startup to its first 200 on /health: the package's
# import and CUDA context, the checkpoint, the 25 projections of kernel B and
# one CUDA graph per bucket (1, 2, 4, 8, 16) at 640², all before the server
# listens. Measured by chip_smoke.py's phase bundle (the entrypoint's api
# mode serving the flagship at 640²) on an NVIDIA H100 80GB HBM3, 700.00 W:
# 24.55 s with the phase run alone, 33.35 s within the whole script; the
# larger is kept.
MEASURED_STARTUP_S = 33.35
# The startup probe allows this many times the measured startup (a slower
# node, a cold page cache, a larger checkpoint) before it restarts the pod.
STARTUP_ALLOWANCE = 3.0
STARTUP_PERIOD_S = 5


def startup_failure_threshold() -> int:
    """Probes of ``STARTUP_PERIOD_S`` that cover ``STARTUP_ALLOWANCE`` x the startup."""
    return math.ceil(STARTUP_ALLOWANCE * MEASURED_STARTUP_S / STARTUP_PERIOD_S)


@dataclass
class CloudDeployConfig:
    """Settings shared by every provider, then each provider's H100 machine."""

    name: str = "hvs-gpu-inference"
    image: str = "hvs-gpu-inference:latest"
    registry: str = ""
    replicas: int = 2
    min_replicas: int = 2
    max_replicas: int = 10
    region: str = "us-central1"
    project: str = "PROJECT_ID"
    rest_port: int = 8000  # the REST server also answers /metrics
    grpc_port: int = 50051
    env: Dict[str, str] = field(default_factory=dict)
    gke_accelerator: str = "nvidia-h100-80gb"  # the GKE node label cloud.google.com/gke-accelerator
    gpus_per_replica: int = 1
    machine_type: str = "a3-highgpu-1g"  # one H100 80GB (GKE node pool, VM, Vertex)
    vertex_accelerator: str = "NVIDIA_H100_80GB"
    sagemaker_instance_type: str = "ml.p5.48xlarge"
    azureml_instance_type: str = "Standard_NC40ads_H100_v5"

    @property
    def full_image(self) -> str:
        return f"{self.registry}/{self.image}" if self.registry else self.image


def _write(path: str, content: str, executable: bool = False) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(content)
    if executable:
        os.chmod(path, 0o755)
    return path


def _yaml(doc: dict, comment: str = "") -> str:
    import yaml

    head = "".join(f"# {line}\n" if line else "#\n" for line in comment.splitlines())
    return head + yaml.safe_dump(doc, sort_keys=False)


def _startup_comment() -> str:
    return (f"Startup probe: {startup_failure_threshold()} probes every "
            f"{STARTUP_PERIOD_S} s, {STARTUP_ALLOWANCE:g} x the serving container's\n"
            f"measured startup of {MEASURED_STARTUP_S:g} s to its first 200 on /health "
            "(chip_smoke.py phase bundle,\nNVIDIA H100 80GB HBM3, 700.00 W); readiness and "
            "liveness probe only after it.")


def pod_spec(cfg: CloudDeployConfig) -> dict:
    """The serving pod: one H100 per pod, the startup probe before readiness
    and liveness."""
    def health(**timing) -> dict:
        return {"httpGet": {"path": "/health", "port": cfg.rest_port}, **timing}

    gpus = str(cfg.gpus_per_replica)
    return {
        "nodeSelector": {"cloud.google.com/gke-accelerator": cfg.gke_accelerator},
        "tolerations": [{"key": "nvidia.com/gpu", "operator": "Exists",
                         "effect": "NoSchedule"}],
        "containers": [{
            "name": "inference",
            "image": cfg.full_image,
            "args": ["api"],
            "resources": {"requests": {"nvidia.com/gpu": gpus, "cpu": "4", "memory": "16Gi"},
                          "limits": {"nvidia.com/gpu": gpus, "memory": "32Gi"}},
            "env": [{"name": k, "value": v} for k, v in cfg.env.items()],
            "ports": [
                {"name": "rest", "containerPort": cfg.rest_port},
                {"name": "grpc", "containerPort": cfg.grpc_port},
            ],
            "startupProbe": health(periodSeconds=STARTUP_PERIOD_S,
                                   failureThreshold=startup_failure_threshold()),
            "readinessProbe": health(periodSeconds=10, failureThreshold=3),
            "livenessProbe": health(periodSeconds=30, failureThreshold=3),
        }],
    }


# ---------------------------------------------------------------------------
# GKE with an H100 node pool


def generate_gke_gpu(cfg: CloudDeployConfig, out_dir: str) -> List[str]:
    """Deployment, Service, HPA, PodMonitoring and deploy.sh."""
    d = os.path.join(out_dir, "gke-gpu")
    deployment = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": cfg.name, "labels": {"app": cfg.name}},
        "spec": {
            "replicas": cfg.replicas,
            "strategy": {"type": "RollingUpdate",
                         "rollingUpdate": {"maxUnavailable": 0, "maxSurge": 1}},
            "selector": {"matchLabels": {"app": cfg.name}},
            "template": {
                "metadata": {
                    "labels": {"app": cfg.name},
                    "annotations": {"prometheus.io/scrape": "true",
                                    "prometheus.io/port": str(cfg.rest_port),
                                    "prometheus.io/path": "/metrics"},
                },
                "spec": pod_spec(cfg),
            },
        },
    }
    service = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": cfg.name},
        "spec": {
            "selector": {"app": cfg.name},
            "ports": [
                {"name": "rest", "port": 80, "targetPort": cfg.rest_port},
                {"name": "grpc", "port": cfg.grpc_port, "targetPort": cfg.grpc_port},
            ],
            "type": "LoadBalancer",
        },
    }
    hpa = {
        "apiVersion": "autoscaling/v2",
        "kind": "HorizontalPodAutoscaler",
        "metadata": {"name": cfg.name},
        "spec": {
            "scaleTargetRef": {"apiVersion": "apps/v1", "kind": "Deployment", "name": cfg.name},
            "minReplicas": cfg.min_replicas,
            "maxReplicas": cfg.max_replicas,
            "metrics": [
                {"type": "Resource",
                 "resource": {"name": "cpu",
                              "target": {"type": "Utilization", "averageUtilization": 70}}},
                {"type": "Pods",
                 "pods": {"metric": {"name": "hvs_requests_per_second"},
                          "target": {"type": "AverageValue", "averageValue": "30"}}},
            ],
        },
    }
    monitoring = {
        "apiVersion": "monitoring.googleapis.com/v1",
        "kind": "PodMonitoring",
        "metadata": {"name": cfg.name},
        "spec": {
            "selector": {"matchLabels": {"app": cfg.name}},
            "endpoints": [{"port": cfg.rest_port, "path": "/metrics", "interval": "15s"}],
        },
    }
    deploy = textwrap.dedent(f"""\
        #!/usr/bin/env bash
        # Deploy {cfg.name} to a GKE cluster with an H100 node pool
        # ({cfg.machine_type}: one {cfg.gke_accelerator} per node, tainted
        # nvidia.com/gpu so that only pods that ask for a card land there).
        set -euo pipefail
        PROJECT="${{PROJECT:-{cfg.project}}}"
        REGION="${{REGION:-{cfg.region}}}"
        CLUSTER="${{CLUSTER:-hvs-gpu}}"
        cd "$(dirname "$0")"

        gcloud container clusters create "$CLUSTER" \\
          --project "$PROJECT" --region "$REGION" --num-nodes 1 || true
        gcloud container node-pools create h100 \\
          --cluster "$CLUSTER" --project "$PROJECT" --region "$REGION" \\
          --machine-type {cfg.machine_type} \\
          --accelerator type={cfg.gke_accelerator},count={cfg.gpus_per_replica},gpu-driver-version=latest \\
          --node-taints nvidia.com/gpu=present:NoSchedule \\
          --enable-autoscaling --min-nodes {cfg.min_replicas} --max-nodes {cfg.max_replicas} || true
        gcloud container clusters get-credentials "$CLUSTER" \\
          --project "$PROJECT" --region "$REGION"
        kubectl apply -f deployment.yaml
        kubectl apply -f service.yaml
        kubectl apply -f hpa.yaml
        kubectl apply -f podmonitoring.yaml
        kubectl rollout status deployment/{cfg.name} --timeout=900s
        """)
    return [
        _write(os.path.join(d, "deployment.yaml"),
               _yaml(deployment, f"{cfg.name} on H100 nodes, one card per pod.\n"
                     + _startup_comment())),
        _write(os.path.join(d, "service.yaml"), _yaml(service)),
        _write(os.path.join(d, "hpa.yaml"), _yaml(hpa)),
        _write(os.path.join(d, "podmonitoring.yaml"), _yaml(monitoring)),
        _write(os.path.join(d, "deploy.sh"), deploy, executable=True),
    ]


# ---------------------------------------------------------------------------
# Vertex AI endpoint on an H100 machine


def generate_vertex_gpu(cfg: CloudDeployConfig, out_dir: str) -> List[str]:
    """A Vertex AI model upload and endpoint deploy script, and its README."""
    d = os.path.join(out_dir, "vertex-gpu")
    script = textwrap.dedent(f"""\
        #!/usr/bin/env python
        \"\"\"Deploy {cfg.name} as a Vertex AI custom-container endpoint on one H100
        per replica. Set PROJECT, REGION and IMAGE, then run. Needs
        google-cloud-aiplatform.\"\"\"
        import os

        from google.cloud import aiplatform

        PROJECT = os.environ.get("PROJECT", "{cfg.project}")
        REGION = os.environ.get("REGION", "{cfg.region}")
        IMAGE = os.environ.get("IMAGE", "{cfg.full_image}")

        aiplatform.init(project=PROJECT, location=REGION)

        model = aiplatform.Model.upload(
            display_name="{cfg.name}",
            serving_container_image_uri=IMAGE,
            serving_container_args=["api"],
            serving_container_predict_route="/detect",
            serving_container_health_route="/health",
            serving_container_ports=[{cfg.rest_port}],
            serving_container_environment_variables={json.dumps(cfg.env)},
        )

        endpoint = aiplatform.Endpoint.create(display_name="{cfg.name}-endpoint")
        endpoint.deploy(
            model=model,
            machine_type="{cfg.machine_type}",
            accelerator_type="{cfg.vertex_accelerator}",
            accelerator_count={cfg.gpus_per_replica},
            min_replica_count={cfg.min_replicas},
            max_replica_count={cfg.max_replicas},
            traffic_percentage=100,
        )
        print("endpoint:", endpoint.resource_name)
        """)
    readme = textwrap.dedent(f"""\
        # Vertex AI endpoint for {cfg.name}

        1. Push the serving image: `docker push {cfg.full_image}`
        2. `python deploy_vertex.py`

        Each replica is a `{cfg.machine_type}` machine with
        {cfg.gpus_per_replica} `{cfg.vertex_accelerator}`. The container serves REST on
        :{cfg.rest_port} (predict `/detect`, health `/health`); `/health`
        answers once the model is loaded and every bucket's CUDA graph is
        captured ({MEASURED_STARTUP_S:g} s measured on an H100).
        """)
    return [
        _write(os.path.join(d, "deploy_vertex.py"), script, executable=True),
        _write(os.path.join(d, "README.md"), readme),
    ]


# ---------------------------------------------------------------------------
# A Compute Engine VM with one H100


def generate_gpu_vm(cfg: CloudDeployConfig, out_dir: str) -> List[str]:
    """gcloud provisioning of a VM with one H100 and a systemd unit that
    runs the serving container."""
    d = os.path.join(out_dir, "gpu-vm")
    env = " ".join(f"-e {k}={v}" for k, v in cfg.env.items())
    unit = textwrap.dedent(f"""\
        [Unit]
        Description={cfg.name} serving on one H100
        After=network-online.target docker.service
        Requires=docker.service

        [Service]
        ExecStartPre=-/usr/bin/docker rm -f {cfg.name}
        ExecStart=/usr/bin/docker run --rm --name {cfg.name} --gpus 1 \\
          -p {cfg.rest_port}:{cfg.rest_port} -p {cfg.grpc_port}:{cfg.grpc_port} {env} \\
          {cfg.full_image} api
        ExecStop=/usr/bin/docker stop -t 30 {cfg.name}
        Restart=always
        RestartSec=5

        [Install]
        WantedBy=multi-user.target
        """)
    deploy = textwrap.dedent(f"""\
        #!/usr/bin/env bash
        # Provision a VM with one H100 ({cfg.machine_type}) and install
        # {cfg.name} as a systemd service that runs the serving container.
        set -euo pipefail
        PROJECT="${{PROJECT:-{cfg.project}}}"
        ZONE="${{ZONE:-{cfg.region}-a}}"
        NAME="${{NAME:-{cfg.name}}}"
        cd "$(dirname "$0")"

        gcloud compute instances create "$NAME" \\
          --project "$PROJECT" --zone "$ZONE" \\
          --machine-type {cfg.machine_type} \\
          --maintenance-policy TERMINATE \\
          --image-family "${{IMAGE_FAMILY:-common-cu128-ubuntu-2204-nvidia-570}}" \\
          --image-project deeplearning-platform-release \\
          --boot-disk-size 200GB \\
          --metadata install-nvidia-driver=True
        gcloud compute scp hvs-gpu.service "$NAME":/tmp/ \\
          --project "$PROJECT" --zone "$ZONE"
        gcloud compute ssh "$NAME" --project "$PROJECT" --zone "$ZONE" --command \\
          'nvidia-smi --query-gpu=compute_cap --format=csv,noheader | grep -qx 9.0 && \\
           sudo mv /tmp/hvs-gpu.service /etc/systemd/system/ && \\
           sudo systemctl daemon-reload && sudo systemctl enable --now hvs-gpu'
        """)
    return [
        _write(os.path.join(d, "hvs-gpu.service"), unit),
        _write(os.path.join(d, "deploy.sh"), deploy, executable=True),
    ]


# ---------------------------------------------------------------------------
# SageMaker and AzureML on H100 instances


def generate_sagemaker(cfg: CloudDeployConfig, out_dir: str) -> List[str]:
    """A SageMaker bring-your-own-container endpoint script and its README."""
    d = os.path.join(out_dir, "sagemaker")
    script = textwrap.dedent(f"""\
        #!/usr/bin/env python
        \"\"\"Deploy {cfg.name} to a SageMaker real-time endpoint on H100 instances.

        SageMaker starts the container with the argument ``serve``: the
        entrypoint then serves REST on port 8080 with ``GET /ping`` and
        ``POST /invocations`` (a /detect request body). Set SAGEMAKER_ROLE.\"\"\"
        import os

        import boto3
        from sagemaker.model import Model

        ROLE = os.environ["SAGEMAKER_ROLE"]
        IMAGE = os.environ.get("IMAGE", "{cfg.full_image}")

        model = Model(
            image_uri=IMAGE,
            role=ROLE,
            name="{cfg.name}",
            env={json.dumps(cfg.env)},
        )
        predictor = model.deploy(
            initial_instance_count={cfg.min_replicas},
            instance_type="{cfg.sagemaker_instance_type}",
            endpoint_name="{cfg.name}",
            container_startup_health_check_timeout={math.ceil(STARTUP_ALLOWANCE * MEASURED_STARTUP_S)},
        )
        boto3.client("application-autoscaling").register_scalable_target(
            ServiceNamespace="sagemaker",
            ResourceId="endpoint/{cfg.name}/variant/AllTraffic",
            ScalableDimension="sagemaker:variant:DesiredInstanceCount",
            MinCapacity={cfg.min_replicas},
            MaxCapacity={cfg.max_replicas},
        )
        print("endpoint:", predictor.endpoint_name)
        """)
    readme = textwrap.dedent(f"""\
        # SageMaker bundle for {cfg.name}

        The endpoint runs the port's serving image on `{cfg.sagemaker_instance_type}`
        (H100). The image carries the package with its kernels built for
        `sm_90a`; it serves the model through the engine, not an exported
        program (a `.pt2` program would also need the package, since it calls
        the registered `hvs::mhc_block` operator). The server uses one card.

        `python deploy_sagemaker.py` (needs `sagemaker` and `boto3`).
        """)
    return [
        _write(os.path.join(d, "deploy_sagemaker.py"), script, executable=True),
        _write(os.path.join(d, "README.md"), readme),
    ]


def generate_azureml(cfg: CloudDeployConfig, out_dir: str) -> List[str]:
    """An AzureML managed online endpoint and deployment, and deploy.sh."""
    d = os.path.join(out_dir, "azureml")
    endpoint = {
        "$schema": "https://azuremlschemas.azureedge.net/latest/"
                   "managedOnlineEndpoint.schema.json",
        "name": cfg.name,
        "auth_mode": "key",
    }
    deployment = {
        "$schema": "https://azuremlschemas.azureedge.net/latest/"
                   "managedOnlineDeployment.schema.json",
        "name": "blue",
        "endpoint_name": cfg.name,
        "environment": {
            "image": cfg.full_image,
            "inference_config": {
                "liveness_route": {"path": "/health", "port": cfg.rest_port},
                "readiness_route": {"path": "/health", "port": cfg.rest_port},
                "scoring_route": {"path": "/detect", "port": cfg.rest_port},
            },
        },
        "environment_variables": cfg.env,
        "instance_type": cfg.azureml_instance_type,
        "instance_count": cfg.min_replicas,
        "readiness_probe": {"initial_delay": math.ceil(MEASURED_STARTUP_S), "period": 10},
        "liveness_probe": {"initial_delay": math.ceil(STARTUP_ALLOWANCE * MEASURED_STARTUP_S),
                           "period": 30},
    }
    sh = textwrap.dedent(f"""\
        #!/usr/bin/env bash
        # Deploy {cfg.name} as an AzureML managed online endpoint on
        # {cfg.azureml_instance_type} (one H100 per instance).
        set -euo pipefail
        cd "$(dirname "$0")"
        az ml online-endpoint create -f endpoint.yaml
        az ml online-deployment create -f deployment.yaml --all-traffic
        az ml online-endpoint show -n {cfg.name} --query scoring_uri
        """)
    return [
        _write(os.path.join(d, "endpoint.yaml"), _yaml(endpoint)),
        _write(os.path.join(d, "deployment.yaml"),
               _yaml(deployment, f"Readiness from the serving container's measured startup of "
                     f"{MEASURED_STARTUP_S:g} s\nto its first 200 on /health (chip_smoke.py phase "
                     f"bundle, NVIDIA H100 80GB HBM3,\n700.00 W); liveness from "
                     f"{STARTUP_ALLOWANCE:g} x that.")),
        _write(os.path.join(d, "deploy.sh"), sh, executable=True),
    ]


PROVIDERS = {
    "gke-gpu": generate_gke_gpu,
    "vertex-gpu": generate_vertex_gpu,
    "gpu-vm": generate_gpu_vm,
    "sagemaker": generate_sagemaker,
    "azureml": generate_azureml,
}


def generate(provider: str, out_dir: str,
             cfg: Optional[CloudDeployConfig] = None) -> List[str]:
    """Write the bundle of one provider under ``out_dir/<provider>``; returns
    the paths written. An unknown provider raises ``ValueError``."""
    if provider not in PROVIDERS:
        raise ValueError(f"unknown provider {provider!r}; choose from {sorted(PROVIDERS)}")
    return PROVIDERS[provider](cfg or CloudDeployConfig(), out_dir)
