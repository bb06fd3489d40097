"""The file set of a container image: what a Dockerfile's build stage copies.

``stage(dockerfile, dest)`` lays out under ``dest`` the files that the
``COPY`` lines of the Dockerfile's first stage take from the build context
(the repository root), where the image would hold them: a path relative to
the stage's ``WORKDIR`` under ``dest/<workdir>``, an absolute one under
``dest/<path>``. Patterns of the Dockerfile's ``.dockerignore`` (beside it,
as BuildKit reads ``<Dockerfile>.dockerignore``) are left out. Building the
kernels and starting the entrypoint from such a copy shows that the image's
file set is enough, without building an image.
"""

from __future__ import annotations

import fnmatch
import os
import shlex
import shutil
from typing import List, Tuple

DEPLOYMENT_DIR = os.path.dirname(os.path.abspath(__file__))
CONTAINER_DIR = os.path.join(DEPLOYMENT_DIR, "container")
KUBERNETES_DIR = os.path.join(DEPLOYMENT_DIR, "kubernetes")
REPO_ROOT = os.path.dirname(os.path.dirname(DEPLOYMENT_DIR))
INFERENCE_DOCKERFILE = os.path.join(CONTAINER_DIR, "Dockerfile.inference")


def instructions(dockerfile: str) -> List[Tuple[str, List[str]]]:
    """(keyword, arguments) of each instruction, continuation lines joined."""
    out, pending = [], ""
    with open(dockerfile) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not pending and line.lstrip().startswith("#"):
                continue
            if line.endswith("\\"):
                pending += line[:-1] + " "
                continue
            line, pending = pending + line, ""
            if line.strip():
                words = shlex.split(line)
                out.append((words[0].upper(), words[1:]))
    return out


def build_stage_copies(dockerfile: str) -> Tuple[str, List[Tuple[List[str], str]]]:
    """The first stage's final ``WORKDIR`` and its ``COPY`` lines from the
    build context, as (sources, destination)."""
    workdir, copies, stages = "/", [], 0
    for keyword, args in instructions(dockerfile):
        if keyword == "FROM":
            stages += 1
            if stages > 1:
                break
        elif keyword == "WORKDIR":
            workdir = os.path.normpath(os.path.join(workdir, args[0]))
        elif keyword == "COPY" and not any(a.startswith("--from") for a in args):
            paths = [a for a in args if not a.startswith("--")]
            dst = paths[-1]
            full = os.path.normpath(os.path.join(workdir, dst))
            copies.append((paths[:-1], full + ("/" if dst.endswith("/") else "")))
    return workdir, copies


def ignore_patterns(dockerfile: str) -> List[str]:
    path = dockerfile + ".dockerignore"
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [line.strip() for line in f if line.strip() and not line.startswith("#")]


def _ignored(rel: str, patterns: List[str]) -> bool:
    parts = rel.split(os.sep)
    for pattern in patterns:
        name = pattern[3:] if pattern.startswith("**/") else pattern
        if fnmatch.fnmatch(rel, pattern) or any(fnmatch.fnmatch(p, name) for p in parts):
            return True
    return False


def stage(dockerfile: str = INFERENCE_DOCKERFILE, dest: str = "",
          context: str = REPO_ROOT) -> dict:
    """Copy the build stage's file set into ``dest``; returns the workdir
    there (``PYTHONPATH`` for the package) and every destination written."""
    workdir, copies = build_stage_copies(dockerfile)
    patterns = ignore_patterns(dockerfile)
    written = []
    for sources, dst in copies:
        if len(sources) != 1 or dst.endswith("/"):
            raise ValueError(f"{dockerfile}: COPY {sources} {dst}: one source to one path only")
        path, out = os.path.join(context, sources[0]), os.path.join(dest, dst.lstrip("/"))
        if os.path.isdir(path):
            shutil.copytree(path, out, dirs_exist_ok=True, ignore=lambda d, names: [
                n for n in names
                if _ignored(os.path.relpath(os.path.join(d, n), context), patterns)])
        else:
            os.makedirs(os.path.dirname(out), exist_ok=True)
            shutil.copy2(path, out)
        written.append(out)
    return {"workdir": os.path.join(dest, workdir.lstrip("/")), "written": written}
