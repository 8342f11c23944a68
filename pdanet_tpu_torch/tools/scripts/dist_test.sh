#!/usr/bin/env bash
# Multi-process evaluation on the GPUs of one host: torchrun starts one
# process per GPU, each running pdanet_tpu_torch.tools.test with
# --launcher pytorch on its shard of the frames; the predictions are
# merged into dataset order and rank 0 evaluates them and writes
# result.pkl.
#
# Runs from the caller's working directory (output/ lands there).
#
# Usage: dist_test.sh <NGPUS> <test args...>
set -euo pipefail
NGPUS=$1
shift
ROOT="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m torch.distributed.run --standalone --nproc_per_node="$NGPUS" \
    -m pdanet_tpu_torch.tools.test --launcher pytorch "$@"
