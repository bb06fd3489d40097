#!/bin/sh
# Entrypoint of the PyTorch/CUDA port's serving and training images.
#
#   entrypoint.sh api [flags]          REST server on $PORT (8000)
#   entrypoint.sh grpc [flags]         gRPC server on $GRPC_PORT (50051)
#   entrypoint.sh serve [flags]        REST on 8080 (SageMaker: /ping, /invocations)
#   entrypoint.sh train [flags]        python -m hvs_tpu_torch.train
#   entrypoint.sh healthcheck          the probe (python -m hvs_tpu_torch.deployment.probe)
#   entrypoint.sh <command> [args]     runs the command as given
#
# Extra flags go to the server or trainer (--checkpoint, --image-size, ...);
# $HVS_IMAGE_SIZE, when set, is the servers' --image-size. Before a server
# or trainer starts, the card is checked: an H100 (compute capability 9.0)
# or nothing starts. Only an explicit --device cpu runs without a card.
set -e

mode="${1:-api}"
[ $# -gt 0 ] && shift

check_card() {
    for arg in "$@"; do
        [ "$prev" = "--device" ] && [ "$arg" = cpu ] && return 0
        [ "$arg" = "--device=cpu" ] && return 0
        prev="$arg"
    done
    python -m hvs_tpu_torch.deployment.probe --card-only || {
        echo "entrypoint: no usable CUDA card; refusing to start" >&2
        exit 1
    }
}

case "$mode" in
  api)
    check_card "$@"
    exec python -m hvs_tpu_torch.deploy serve --backend rest --port "${PORT:-8000}" \
        ${HVS_IMAGE_SIZE:+--image-size "$HVS_IMAGE_SIZE"} "$@"
    ;;
  grpc)
    check_card "$@"
    exec python -m hvs_tpu_torch.deploy serve --backend grpc --port "${GRPC_PORT:-50051}" \
        ${HVS_IMAGE_SIZE:+--image-size "$HVS_IMAGE_SIZE"} "$@"
    ;;
  serve)
    check_card "$@"
    exec python -m hvs_tpu_torch.deploy serve --backend rest --port 8080 \
        ${HVS_IMAGE_SIZE:+--image-size "$HVS_IMAGE_SIZE"} "$@"
    ;;
  train)
    check_card "$@"
    exec python -m hvs_tpu_torch.train "$@"
    ;;
  healthcheck)
    exec python -m hvs_tpu_torch.deployment.probe "$@"
    ;;
  *)
    exec "$mode" "$@"
    ;;
esac
