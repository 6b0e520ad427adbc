#!/usr/bin/env bash
# The end-to-end gate on one card: the product recipe at full scale (bf16,
# pt2pl, four training sequences, lr 1e-4, clip 10, 60 epochs), then the
# deployment protocol on the run it trained. Run from the repository root:
#
#   bash mm_masking_tpu_torch/benchmarks/e2e_gate.sh <run-name> <train.seed> <out-dir>
#
# Writes to <out-dir>: card.txt (the card's name and power limit), train.log
# (the recipe's stdout, its summary the last line) and train.err (its
# stderr, the wall times among it), train_summary.json, the run's
# config.json and run_metrics.jsonl, deploy.log and deploy/ (the protocol's
# summaries, stats and trajectories; the .pt checkpoints stay under
# results/checkpoints/<run-name>), and wall.txt (the whole gate's seconds).
set -euo pipefail
run=$1
seed=$2
out=$3
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
start=$(date +%s.%N)
python -m mm_masking_tpu_torch.benchmarks.e2e_product --scale full --train-seqs 4 \
    --lr 1e-4 --clip 10 --epochs 60 --seed "$seed" --run-name "$run" \
    > "$out/train.log" 2> "$out/train.err"
tail -n 1 "$out/train.log" > "$out/train_summary.json"
root=$(python -c "import os, tempfile; print(os.path.join(tempfile.gettempdir(), 'e2e_product_m4'))")
python -m mm_masking_tpu_torch.benchmarks.eval_deployment --root "$root" \
    --checkpoint "results/checkpoints/$run" --out "results/$run" > "$out/deploy.log" 2>&1
cp "results/checkpoints/$run/config.json" "results/checkpoints/$run/run_metrics.jsonl" "$out/"
mkdir -p "$out/deploy"
cp results/"$run"/*.json results/"$run"/*.txt "$out/deploy/"
python -c "import time; print(time.time() - $start)" | tee "$out/wall.txt"
