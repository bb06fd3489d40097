#!/bin/bash
# Build (and optionally push) the PyTorch/CUDA port's serving and training
# images for NVIDIA H100 hosts.
#
#   hvs_tpu_torch/deployment/container/build.sh --type inference --tag v1.2 \
#       --registry us-docker.pkg.dev/my-proj/hvs --push
#   hvs_tpu_torch/deployment/container/build.sh --type train
#   hvs_tpu_torch/deployment/container/build.sh --type all --no-cache --dry-run
set -euo pipefail

GREEN='\033[0;32m'; RED='\033[0;31m'; NC='\033[0m'

TAG="latest"
TYPE="inference"          # inference | train | all
REGISTRY=""
PUSH=false
NO_CACHE=""
DRY_RUN=false

while [[ $# -gt 0 ]]; do
    case $1 in
        --tag)      TAG="$2"; shift 2 ;;
        --type)     TYPE="$2"; shift 2 ;;
        --registry) REGISTRY="$2"; shift 2 ;;
        --push)     PUSH=true; shift ;;
        --no-cache) NO_CACHE="--no-cache"; shift ;;
        --dry-run)  DRY_RUN=true; shift ;;
        -h|--help)
            grep '^#' "$0" | sed 's/^# \{0,1\}//'; exit 0 ;;
        *) echo -e "${RED}unknown arg: $1${NC}" >&2; exit 2 ;;
    esac
done

HERE="$(cd "$(dirname "$0")" && pwd)"
ROOT="$(cd "$HERE/../../.." && pwd)"

run() {
    echo -e "${GREEN}\$ $*${NC}"
    $DRY_RUN || "$@"
}

build_one() {
    local type="$1"
    local image="hvs-gpu-${type}:${TAG}"
    run docker build $NO_CACHE -f "$HERE/Dockerfile.${type}" -t "$image" "$ROOT"
    if $PUSH; then
        [[ -n "$REGISTRY" ]] || { echo -e "${RED}--push needs --registry${NC}" >&2; exit 2; }
        run docker tag "$image" "${REGISTRY}/${image}"
        run docker push "${REGISTRY}/${image}"
    fi
}

case "$TYPE" in
    inference|train) build_one "$TYPE" ;;
    all) build_one inference; build_one train ;;
    *) echo -e "${RED}--type must be inference|train|all${NC}" >&2; exit 2 ;;
esac
