#!/bin/bash
# Run lines of scripts/run_vae_dbmnist.sh through the PyTorch port, all at
# once on one card, one driver process a line, for a 60k gate:
#
#   scripts/torch_gate_lines.sh WORKDIR LOGDIR LINE [LINE ...] [-- FLAGS...]
#
# Each line's flags (its module ardae_tpu.cli.X becomes ardae_tpu_torch.cli.X)
# plus run_canonical_sweep.sh's COMMON with --vis-interval 0, plus
# --use-kernels on an implicit (ivae_ardae) line unless FLAGS run phase A in
# bf16 (--cdae-compute-dtype bfloat16: the kernels are fp32 only), plus FLAGS. The experiment
# directories and the data live under WORKDIR (a checkpoint is 10-80 MB);
# each process's output goes to LOGDIR/line<N>.out and, when it ends, its
# experiment's log.txt to LOGDIR/line<N>.log. Exits non-zero if a run failed.
set -u
cd "$(dirname "$0")/.."
WORK="$1"; LOGS="$2"; shift 2
LINES=()
while [ $# -gt 0 ] && [ "$1" != "--" ]; do LINES+=("$1"); shift; done
[ $# -gt 0 ] && shift
EXTRA="$*"
COMMON="--seed 1 --eval-batch-size 128 --max-iters 60000 --eval-iws-interval 5000 --iws-samples 256 --log-interval 1000 --ckpt-interval 5000 --vis-interval 0"
mkdir -p "$WORK" "$LOGS"

run_line () {  # $1 = line number of scripts/run_vae_dbmnist.sh
  local cmd kernels=""
  cmd=$(sed -n "${1}p" scripts/run_vae_dbmnist.sh \
        | sed 's#ardae_tpu\.cli\.#ardae_tpu_torch.cli.#' \
        | sed "s#--cache [^ ]*#--cache $WORK/exp#")
  case "$cmd" in
    *ardae_tpu_torch.cli.ivae_ardae*)
      case "$EXTRA" in
        *"--cdae-compute-dtype bfloat16"*) ;;
        *) kernels="--use-kernels" ;;
      esac ;;
    *ardae_tpu_torch.cli.vae*) ;;
    *) echo "line $1 is not a driver line: $cmd" >&2; return 2 ;;
  esac
  echo "=== line $1: $cmd $COMMON $kernels --data-root $WORK/data-$1 $EXTRA"
  # shellcheck disable=SC2086
  eval "$cmd $COMMON $kernels --data-root $WORK/data-$1 $EXTRA"
  local rc=$?
  local exp
  exp=$(grep -o "path='[^']*'" "$LOGS/line$1.out" | head -n 1 | cut -d"'" -f2)
  [ -n "$exp" ] && cp "$exp/log.txt" "$LOGS/line$1.log"
  return $rc
}

pids=()
for n in "${LINES[@]}"; do
  run_line "$n" > "$LOGS/line$n.out" 2>&1 &
  pids+=($!)
done
status=0
for i in "${!pids[@]}"; do
  if ! wait "${pids[$i]}"; then
    echo "line ${LINES[$i]} FAILED (see $LOGS/line${LINES[$i]}.out)"
    status=1
  fi
done
exit $status
