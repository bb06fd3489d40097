"""The port's deployment bundle for NVIDIA H100 hosts, on the CPU.

Counterparts of ``tests/test_infra.py``'s structure tests for the port's
container files (``hvs_tpu_torch/deployment/container/``), cluster files
(``deployment/kubernetes/``) and cloud bundles (``deployment/cloud_codegen.py``),
with the deploy tool's subcommands, the health probe, the kernel build step,
and the serving entrypoint run live from the image's file set with a tiny
model. Also the trained-site gates of ``scripts/torch_trained_checks.py``
on synthetic readings. Nothing here needs a card or ``nvcc``.
"""

import base64
import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from hvs_tpu_torch import build, deploy
from hvs_tpu_torch.deployment import cloud_codegen, image_files, probe

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTAINER = image_files.CONTAINER_DIR
KUBERNETES = image_files.KUBERNETES_DIR
FORBIDDEN = re.compile(r"jax|libtpu|google\.com/tpu|gke-tpu|tpu-", re.IGNORECASE)


def _read(*parts):
    with open(os.path.join(*parts)) as f:
        return f.read()


def _k8s(name):
    return [d for d in yaml.safe_load_all(_read(KUBERNETES, name)) if d]


def _stages(dockerfile):
    """Each stage's instructions, keyed by its position."""
    stages = []
    for keyword, args in image_files.instructions(dockerfile):
        if keyword == "FROM":
            stages.append([])
        if stages:
            stages[-1].append((keyword, args))
    return stages


# ---------------- the container (test_infra.py's Dockerfile tests) ----------


@pytest.mark.parametrize("kind", ["inference", "train"])
def test_dockerfile_stages_build_the_kernels_and_run_unprivileged(kind):
    path = os.path.join(CONTAINER, f"Dockerfile.{kind}")
    build_stage, runtime = _stages(path)
    assert "-devel-" in build_stage[0][1][0] and "-runtime-" in runtime[0][1][0]
    assert ("RUN", ["python", "-m", "hvs_tpu_torch.build"]) in build_stage
    assert not any("hvs_tpu_torch.build" in " ".join(a) for k, a in runtime if k == "RUN")
    sources = [a[0] for k, a in build_stage if k == "COPY"]
    assert any(os.path.join("hvs_tpu_torch", "csrc").startswith(s.rstrip("/")) for s in sources)
    users = [a[0] for k, a in runtime if k == "USER"]
    assert users and users[-1] not in ("root", "0")
    assert ("COPY", ["--from=build", "/app", "/app"]) in runtime
    assert not FORBIDDEN.search(_read(path))


def test_image_file_set_holds_the_kernel_sources_and_no_build(tmp_path):
    staged = image_files.stage(dest=str(tmp_path))
    app = staged["workdir"]
    for name in build.sources():
        assert os.path.isfile(os.path.join(app, "hvs_tpu_torch", "csrc", f"{name}.cu"))
    assert os.access(os.path.join(str(tmp_path), "entrypoint.sh"), os.X_OK)
    for root, dirs, _ in os.walk(app):
        assert "_build" not in dirs and "__pycache__" not in dirs, root


def test_entrypoint_modes():
    content = _read(CONTAINER, "entrypoint.sh")
    for mode in ("api)", "grpc)", "train)", "healthcheck)", "serve)", "*)"):
        assert mode in content
    assert "python -m hvs_tpu_torch.deploy serve --backend rest" in content
    assert "python -m hvs_tpu_torch.deploy serve --backend grpc" in content
    assert "exec python -m hvs_tpu_torch.train" in content
    assert "exec python -m hvs_tpu_torch.deployment.probe" in content
    assert "probe --card-only" in content
    assert not FORBIDDEN.search(content)


@pytest.mark.parametrize("mode", ["api", "train"])
def test_entrypoint_refuses_to_start_without_a_card(mode):
    proc = subprocess.run(["sh", os.path.join(CONTAINER, "entrypoint.sh"), mode],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stdout and "refusing to start" in proc.stderr


def test_compose_reserves_one_nvidia_gpu_per_service():
    compose = yaml.safe_load(_read(CONTAINER, "docker-compose.yml"))
    services = compose["services"]
    assert {"api", "grpc", "train"} <= set(services)
    for name, service in services.items():
        devices = service["deploy"]["resources"]["reservations"]["devices"]
        assert devices == [{"driver": "nvidia", "count": 1, "capabilities": ["gpu"]}], name
        assert service["build"]["dockerfile"].startswith("hvs_tpu_torch/deployment/container/")
    assert services["api"]["healthcheck"]["test"] == ["CMD", "/entrypoint.sh", "healthcheck"]


def test_build_script_dry_runs_both_images():
    path = os.path.join(CONTAINER, "build.sh")
    assert os.access(path, os.X_OK)
    out = subprocess.run(["bash", path, "--type", "all", "--dry-run"], capture_output=True,
                         text=True, check=True).stdout
    assert "Dockerfile.inference" in out and "Dockerfile.train" in out
    assert "hvs-gpu-inference:latest" in out and "hvs-gpu-train:latest" in out
    rc = subprocess.run(["bash", path, "--type", "inference", "--dry-run", "--push"],
                        capture_output=True, text=True)
    assert rc.returncode != 0


def test_docker_healthcheck_covers_the_measured_startup():
    content = _read(CONTAINER, "Dockerfile.inference")
    start = int(re.search(r"--start-period=(\d+)s", content).group(1))
    assert start >= cloud_codegen.STARTUP_ALLOWANCE * cloud_codegen.MEASURED_STARTUP_S
    assert 'CMD ["/entrypoint.sh", "healthcheck"]' in content
    compose = yaml.safe_load(_read(CONTAINER, "docker-compose.yml"))
    assert compose["services"]["api"]["healthcheck"]["start_period"] == f"{start}s"


# ---------------- the cluster (test_infra.py's Kubernetes tests) ------------


def test_k8s_deployment_asks_for_one_h100_per_pod():
    (dep,) = _k8s("deployment.yaml")
    assert dep["kind"] == "Deployment"
    spec = dep["spec"]
    assert spec["strategy"]["rollingUpdate"]["maxUnavailable"] == 0
    pod = spec["template"]["spec"]
    assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    assert {"key": "nvidia.com/gpu", "operator": "Exists",
            "effect": "NoSchedule"} in pod["tolerations"]
    container = pod["containers"][0]
    assert container["resources"]["requests"]["nvidia.com/gpu"] == "1"
    assert container["resources"]["limits"]["nvidia.com/gpu"] == "1"
    startup = container["startupProbe"]
    assert startup["httpGet"]["path"] == "/health"
    assert startup["periodSeconds"] == cloud_codegen.STARTUP_PERIOD_S
    assert startup["failureThreshold"] == cloud_codegen.startup_failure_threshold()
    assert {"readinessProbe", "livenessProbe"} <= set(container)
    assert f"{cloud_codegen.MEASURED_STARTUP_S:g} s" in _read(KUBERNETES, "deployment.yaml")
    priority = {d["metadata"]["name"] for d in _k8s("gpu-scheduler.yaml")
                if d["kind"] == "PriorityClass"}
    assert pod["priorityClassName"] in priority


def test_k8s_service_ports_match_deployment():
    (svc,), (dep,) = _k8s("service.yaml"), _k8s("deployment.yaml")
    ports = {p["containerPort"] for p in dep["spec"]["template"]["spec"]["containers"][0]["ports"]}
    assert svc["spec"]["selector"] == dep["spec"]["selector"]["matchLabels"]
    for port in svc["spec"]["ports"]:
        assert port["targetPort"] in ports


def test_k8s_configmap_and_hpa_reference_the_deployment():
    (cm,), (dep,), (hpa,) = _k8s("configmap.yaml"), _k8s("deployment.yaml"), _k8s("hpa.yaml")
    env_from = dep["spec"]["template"]["spec"]["containers"][0]["envFrom"]
    assert env_from[0]["configMapRef"]["name"] == cm["metadata"]["name"]
    assert cm["data"]["HVS_IMAGE_SIZE"] == "640"
    assert hpa["spec"]["scaleTargetRef"]["name"] == dep["metadata"]["name"]
    assert (hpa["spec"]["minReplicas"], hpa["spec"]["maxReplicas"]) == (2, 10)


def test_k8s_secrets_template_has_no_real_values():
    docs = _k8s("secrets.yaml")
    secret = next(d for d in docs if d["type"] == "Opaque")
    assert secret["stringData"]["api-auth-token"] in ("", "CHANGE-ME")
    assert all(v.strip() in ("", "{}", "CHANGE-ME") for v in secret["stringData"].values())
    pull = next(d for d in docs if d["type"] == "kubernetes.io/dockerconfigjson")
    assert base64.b64decode(pull["data"][".dockerconfigjson"]) == b"{}"


def test_k8s_gpu_scheduler_contract():
    docs = _k8s("gpu-scheduler.yaml")
    assert [d["kind"] for d in docs].count("PriorityClass") == 2
    by_name = {d["metadata"]["name"]: d for d in docs}
    assert by_name["hvs-gpu-serving"]["value"] > by_name["hvs-gpu-batch"]["value"]
    contract = by_name["hvs-gpu-scheduling-contract"]["data"]
    (dep,) = _k8s("deployment.yaml")
    pod = dep["spec"]["template"]["spec"]
    assert yaml.safe_load(contract["node-selector"]) == pod["nodeSelector"]
    assert yaml.safe_load(contract["toleration"]) in pod["tolerations"]
    assert yaml.safe_load(contract["resources"]) == {
        k: {"nvidia.com/gpu": v["nvidia.com/gpu"]}
        for k, v in pod["containers"][0]["resources"].items()}
    assert contract["gpus-per-serving-pod"] == "1"


# ---------------- cloud bundles (test_infra.py's codegen tests) -------------


@pytest.mark.parametrize("provider", sorted(cloud_codegen.PROVIDERS))
def test_cloud_bundle_files_parse(provider, tmp_path):
    from hvs_tpu_torch.deployment import generate_cloud_bundle

    files = generate_cloud_bundle(provider, str(tmp_path))
    assert files and all(f.startswith(os.path.join(str(tmp_path), provider)) for f in files)
    for path in files:
        text = _read(path)
        if path.endswith(".yaml"):
            assert list(yaml.safe_load_all(text))
        elif path.endswith(".py"):
            compile(text, path, "exec")
        elif path.endswith(".sh"):
            assert os.access(path, os.X_OK)
            subprocess.run(["bash", "-n", path], check=True)
        assert not FORBIDDEN.search(text), path
    text = "".join(_read(p) for p in files)
    assert re.search(r"h100|a3-highgpu|p5\.|H100", text, re.IGNORECASE)


def test_gke_gpu_manifest_schema(tmp_path):
    from hvs_tpu_torch.deployment import CloudDeployConfig, generate_cloud_bundle

    cfg = CloudDeployConfig(image="img:v1", registry="gcr.io/p", replicas=3)
    generate_cloud_bundle("gke-gpu", str(tmp_path), cfg)
    d = os.path.join(str(tmp_path), "gke-gpu")
    dep = yaml.safe_load(_read(d, "deployment.yaml"))
    spec = dep["spec"]["template"]["spec"]
    assert spec["nodeSelector"]["cloud.google.com/gke-accelerator"] == "nvidia-h100-80gb"
    container = spec["containers"][0]
    assert container["image"] == "gcr.io/p/img:v1"
    assert container["resources"]["limits"]["nvidia.com/gpu"] == "1"
    assert container["resources"]["requests"]["nvidia.com/gpu"] == "1"
    probe_ = container["startupProbe"]
    assert probe_["periodSeconds"] * probe_["failureThreshold"] >= (
        cloud_codegen.STARTUP_ALLOWANCE * cloud_codegen.MEASURED_STARTUP_S)
    assert dep["spec"]["replicas"] == 3
    assert yaml.safe_load(_read(d, "hpa.yaml"))["spec"]["maxReplicas"] == cfg.max_replicas
    sh = _read(d, "deploy.sh")
    for manifest in ("deployment", "service", "hpa", "podmonitoring"):
        assert f"{manifest}.yaml" in sh
    assert "--accelerator type=nvidia-h100-80gb,count=1" in sh


def test_cloud_codegen_unknown_provider(tmp_path):
    from hvs_tpu_torch.deployment import generate_cloud_bundle

    with pytest.raises(ValueError):
        generate_cloud_bundle("ec2", str(tmp_path))
    with pytest.raises(SystemExit):
        deploy.parse_args(["cloud", "--provider", "gke-" + "tpu"])


def test_no_shipped_or_generated_file_names_the_tpu_stack(tmp_path):
    shipped = [os.path.join(d, f) for d in (CONTAINER, KUBERNETES) for f in os.listdir(d)]
    shipped.append(os.path.join(os.path.dirname(KUBERNETES), "defaults.yaml"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        for provider in cloud_codegen.PROVIDERS:
            assert deploy.main(["cloud", "--provider", provider,
                                "--out-dir", str(tmp_path)]) == 0
    generated = [os.path.join(r, f) for r, _, fs in os.walk(str(tmp_path)) for f in fs]
    assert len(generated) == out.getvalue().count("wrote ") >= 10
    for path in shipped + generated:
        assert not FORBIDDEN.search(_read(path)), path


# ---------------- the deploy tool ----------------------------------------------


def _printed(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = deploy.main(argv)
    return rc, [line[2:] for line in out.getvalue().splitlines() if line.startswith("$ ")]


def test_deploy_defaults_layer_under_explicit_flags(tmp_path):
    rc, cmds = _printed(["docker", "--dry-run"])
    assert rc == 0 and "-t hvs-gpu-inference:latest" in cmds[0]
    assert cmds[0].split()[3].endswith("hvs_tpu_torch/deployment/container/Dockerfile.inference")
    config = tmp_path / "deploy.yaml"
    config.write_text("docker:\n  tag: from-yaml:v2\nk8s:\n  namespace: yaml-ns\n")
    rc, cmds = _printed(["--config", str(config), "docker", "--dry-run"])
    assert "-t from-yaml:v2" in cmds[0]
    rc, cmds = _printed(["--config", str(config), "docker", "--dry-run", "--tag", "override:v9"])
    assert "-t override:v9" in cmds[0]
    rc, cmds = _printed(["--config", str(config), "k8s", "--dry-run"])
    assert all("yaml-ns" in c for c in cmds if c.startswith("kubectl apply"))
    args = deploy.parse_args(["--config", str(config), "serve", "--device", "cpu"])
    assert (args.port, args.backend, args.image_size) == (8000, "rest", None)


def test_k8s_dry_run_applies_the_scheduler_first_and_every_manifest():
    rc, cmds = _printed(["k8s", "--dry-run"])
    applied = [os.path.basename(c.split()[-1]) for c in cmds if c.startswith("kubectl apply")]
    assert rc == 0 and applied[:3] == ["gpu-scheduler.yaml", "configmap.yaml", "secrets.yaml"]
    assert sorted(applied) == sorted(f for f in os.listdir(KUBERNETES) if f.endswith(".yaml"))
    assert cmds[-1].startswith("kubectl rollout status -n hvs-gpu deployment/hvs-gpu-inference")


def test_edge_dry_run_checks_the_compute_capability_before_any_copy():
    rc, cmds = _printed(["edge", "--host", "robot-01", "--dry-run"])
    assert rc == 0
    assert cmds[0] == ("ssh robot@robot-01 nvidia-smi --query-gpu=compute_cap "
                       "--format=csv,noheader")
    assert [c.split()[0] for c in cmds[1:]] == ["ssh", "scp", "ssh"]
    assert "python -m hvs_tpu_torch.infer --source 0" in cmds[-1]


@pytest.mark.parametrize("reading,rc", [("8.7\n", 1), ("9.0\n8.9\n", 1), ("9.0\n", 0)])
def test_edge_stops_unless_every_card_reads_9_0(monkeypatch, reading, rc):
    calls = []

    def fake_run(cmd, capture_output=False, text=False):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, reading if capture_output else "", "")

    monkeypatch.setattr(deploy.subprocess, "run", fake_run)
    with contextlib.redirect_stdout(io.StringIO()):
        assert deploy.DeploymentManager().edge_deploy("robot-01") == rc
    assert len(calls) == (4 if rc == 0 else 1)
    assert not any(c[0] == "scp" for c in calls) or rc == 0


# ---------------- the build step and the probe -------------------------------


def test_build_main_without_nvcc_exits_nonzero(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    isfile = os.path.isfile
    monkeypatch.setattr(build.os.path, "isfile", lambda p: not p.endswith("nvcc") and isfile(p))
    assert build.main([]) == 1
    assert "nvcc not found" in capsys.readouterr().err


def test_build_main_lists_each_current_library(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    for name in build.sources():
        build._library_path(name).write_bytes(b"")
    assert build.main([]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert {os.path.basename(x["source"]) for x in lines[:-1]} == {
        "group_norm.cu", "mhc_block.cu", "relpos_attention.cu", "sinkhorn.cu"}
    assert all(x["library"].startswith(str(tmp_path)) for x in lines[:-1])
    assert lines[-1]["built"] == 0 and lines[-1]["current"] == len(build.sources())


def test_probe_without_a_card_exits_nonzero_naming_why():
    proc = subprocess.run([sys.executable, "-m", "hvs_tpu_torch.deployment.probe"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["status"] == "unhealthy" and "no CUDA card" in report["reason"]


def test_probe_refuses_another_card_and_unbuilt_kernels(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: (8, 0))
    with pytest.raises(probe.Unhealthy, match=r"compute capability \(8, 0\)"):
        probe.run()
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: (9, 0))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(probe.Unhealthy, match="not built for the current source"):
        probe.run()
    assert probe.run(card_only=True)["capability"] == [9, 0]
    assert not list(tmp_path.iterdir())  # the probe built nothing


def test_probe_limits_are_the_chip_checks():
    import chip_smoke

    assert (probe.KERNEL_MIN_CORR, probe.KERNEL_MAX_MEAN_ABS) == (
        chip_smoke.KERNEL_MIN_CORR, chip_smoke.KERNEL_MAX_MEAN_ABS)
    assert (probe.SINK_P_ATOL, probe.SINK_ROW_ATOL) == (
        chip_smoke.SINK_P_ATOL, chip_smoke.SINK_ROW_ATOL)


# ---------------- the entrypoint's api mode, live, from the image's file set --


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _conditioned_tiny_checkpoint(path):
    """The tiny model's seeded weights with the prediction convs conditioned
    as ``chip_smoke.conditioned_params`` does, so detections are not empty."""
    from chip_smoke import conditioned_params
    from hvs_tpu_torch.config import InferenceConfig, ModelConfig
    from hvs_tpu_torch.export_model import tiny_configs

    mcfg = ModelConfig(device="cpu")
    tiny_configs(mcfg, InferenceConfig(device="cpu"), 64)
    torch.save({"params": conditioned_params(0, mcfg)}, path)


def test_entrypoint_api_serves_the_tiny_model_on_the_cpu(tmp_path):
    import cv2

    from hvs_tpu_torch.inference.preprocessing import decode_jpeg

    staged = image_files.stage(dest=str(tmp_path / "image"))
    checkpoint = str(tmp_path / "tiny.pt")
    _conditioned_tiny_checkpoint(checkpoint)
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=staged["workdir"], PORT=str(port), OMP_NUM_THREADS="1")
    server = subprocess.Popen(
        ["sh", str(tmp_path / "image" / "entrypoint.sh"), "api", "--device", "cpu", "--tiny",
         "--checkpoint", checkpoint], cwd=str(run_dir), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        engine = deploy.build_engine(deploy.parse_args(
            ["serve", "--device", "cpu", "--tiny", "--checkpoint", checkpoint]))
        frame = np.random.default_rng(0).integers(0, 256, (120, 200, 3), dtype=np.uint8)
        blob = cv2.imencode(".jpg", frame)[1].tobytes()
        want = engine.infer(decode_jpeg(blob, engine.image_size))
        assert len(want) > 0
        for _ in range(240):
            assert server.poll() is None, server.stdout.read().decode()[-2000:]
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as resp:
                    health = json.loads(resp.read())
                break
            except OSError:
                time.sleep(0.25)
        assert health["status"] == "healthy" and health["model_loaded"]
        req = urllib.request.Request(
            url + "/detect", data=json.dumps({"image_base64": base64.b64encode(blob).decode()})
            .encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        assert body["image_size"] == [120, 200]
        got = body["detections"]
        assert [d["class_id"] for d in got] == want.classes.tolist()
        np.testing.assert_allclose([d["box"] for d in got], want.boxes, atol=1e-3)
        np.testing.assert_allclose([d["score"] for d in got], want.scores, atol=1e-5)
        with urllib.request.urlopen(url + "/ping", timeout=5) as resp:
            assert json.loads(resp.read())["status"] == "healthy"
    finally:
        server.terminate()
        server.wait(timeout=30)
        server.stdout.close()


# ---------------- the trained-site gates (scripts/torch_trained_checks.py) ---


def _checks():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import torch_trained_checks
    finally:
        sys.path.pop(0)
    return torch_trained_checks


def _site(corr, mean_abs, plain64, kernel64, name="s"):
    return {"kernel": "A", "site": name, "corr": corr, "mean_abs": mean_abs,
            "plain_vs_fp64_corr": plain64, "kernel_vs_fp64_corr": kernel64}


@pytest.mark.parametrize("reading,gate,ok", [
    # well conditioned: the plain version resolves the function at 0.9999
    (_site(0.99999, 1e-3, 0.99995, 0.99996), "plain", True),
    # the fault case: plain at 0.9999 against fp64, the kernel under it against plain
    (_site(0.9990, 1e-3, 0.99995, 0.99990), "plain", False),
    (_site(0.99999, 6e-3, 0.99995, 0.99996), "plain", False),
    # GELU-conditioned: held at the fp64 margin
    (_site(0.9950, 2e-2, 0.8400, 0.8395), "fp64", True),
    (_site(0.9950, 2e-2, 0.8400, 0.8380), "fp64", False),
])
def test_trained_site_takes_the_gate_bf16_lets_it_measure(reading, gate, ok):
    checks = _checks()
    (row,) = checks.gate_sites([dict(reading)])
    assert (row["gate"], row["ok"]) == (gate, ok)
    failures = checks.gate_failures([row], None)
    assert bool(failures) != ok
    counts = checks.gate_counts([row], None)
    assert counts["A"][gate] == 1 and counts["C"] == {"plain": 0, "fp64": 0}


def test_serve_parity_gates_by_scale():
    checks = _checks()
    assert checks.GELU_FP64_MARGIN == pytest.approx(__import__("chip_smoke").GELU_FP64_MARGIN)
    parity = {"small": {"corr": 0.9953, "mean_abs": 0.02},
              "medium": {"corr": 0.7705, "mean_abs": 0.04},
              "large": {"corr": 0.9995, "mean_abs": 0.01}}
    fp64 = {"card_vs_fp64": {"small": {"corr": 0.9920}, "medium": {"corr": 0.8402},
                             "large": {"corr": 0.9996}},
            "cpu_vs_fp64": {"small": {"corr": 0.9929}, "medium": {"corr": 0.8320},
                            "large": {"corr": 0.9995}}}
    gates = checks.gate_parity(parity, fp64)
    assert {k: (v["gate"], v["ok"]) for k, v in gates.items()} == {
        "small": ("fp64", True), "medium": ("fp64", True), "large": ("plain", True)}
    fp64["card_vs_fp64"]["small"]["corr"] = 0.9910
    parity["large"]["corr"] = 0.9985
    gates = checks.gate_parity(parity, fp64)
    assert not gates["small"]["ok"] and not gates["large"]["ok"]
    assert len(checks.gate_failures([], gates)) == 2
    assert checks.gate_counts([], gates)["parity"] == {"plain": 1, "fp64": 2}
