#!/bin/bash
# The fm9 regime of RESULTS.md through the port's command line, on the GPU:
# a synthetic corpus of 1280 songs, configs/ae_freebits.yaml, ed.yaml and
# gan.yaml at their own epochs, λ_fm = 10; then eval-gen (8 fresh samples an
# emotion), the quality gate at both tiers and diagnose. Run from the root of
# a checkout:
#   bash fm9_run.sh [WORKDIR] [OUTDIR]     (defaults build/fm9, build/fm9_out)
# Logs, pipeline_timings.json and eval_gen.json land in OUTDIR; the card's
# name and power limit are printed first and last.
W=${1:-build/fm9}
O=${2:-build/fm9_out}
mkdir -p "$O"
rm -rf "$W"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$O/smi.txt"
S="--splits-dir $W/data/splits --processed-dir $W/data/processed"
t0=$(date +%s%N)
python -m melogan_torch pipeline --workdir "$W" --synthetic --per-emotion 320 \
  --ae-config configs/ae_freebits.yaml --ed-config configs/ed.yaml \
  --gan-config configs/gan.yaml --gan-fm 10 > "$O/pipeline.log" 2>&1
echo "pipeline rc $? wall_ms $(( ($(date +%s%N) - t0) / 1000000 ))"
head -n 3 "$O/pipeline.log"; grep "epoch 1\]\|epoch 1/" "$O/pipeline.log"; tail -n 3 "$O/pipeline.log"
cp "$W/pipeline_timings.json" "$O/" 2>/dev/null && cat "$O/pipeline_timings.json"; echo
python -m melogan_torch eval-gen --workdir "$W" $S --samples 8 > "$O/eval_gen.log" 2>&1
echo "eval-gen rc $?"; tail -n 12 "$O/eval_gen.log"
cp "$W/eval_gen.json" "$O/"
for t in default strict; do
  python -m melogan_torch quality-gate "$W/generated_tests" --tier $t --no-strict > "$O/gate_$t.log" 2>&1
  echo "gate $t rc $?"; tail -n 1 "$O/gate_$t.log"
done
python -m melogan_torch diagnose --split train $S > "$O/diagnose.log" 2>&1; echo "diagnose rc $?"
python -c "import json, sys; r = json.load(open(sys.argv[1])); print(json.dumps({'ok': r['ok'], 'latent_structure': r.get('latent_structure')}))" "$O/diagnose.log"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
