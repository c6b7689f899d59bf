#!/bin/bash
# The whole chip_smoke.py of two trees in one run on one card, in the
# order parent, change, change, parent, each from its own directory and
# each building its kernels afresh; prints each run's exit code, seconds
# of wall time and RMVPE's seconds a segment (a gauge of the host's
# speed), and keeps each run's output under chiprun_out/.
#
# From the repository's root on a machine with one card:
#
#   git archive <parent commit> | tar -x -C _archive/parent
#   git archive $(git write-tree) | tar -x -C _archive/change
#   bash stylish_tts_tpu_torch/scripts/smoke_pair.sh [PARENT_DIR] [CHANGE_DIR]
#
# Both directories lie two levels below the repository's root (as
# _archive/<name> does, which .gitignore lists).
set -u
parent_dir=${1:-_archive/parent}
change_dir=${2:-_archive/change}
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
summary=""
for pair in "parent:$parent_dir" "change:$change_dir" "change2:$change_dir" "parent2:$parent_dir"; do
  tag=${pair%%:*}; dir=${pair#*:}
  rm -rf "$dir/chiprun_out" "$dir/stylish_tts_tpu_torch/build"
  t0=$(date +%s.%N)
  (cd "$dir" && python3 chip_smoke.py > "../../chiprun_out/smoke_pair_${tag}.log" 2> "../../chiprun_out/smoke_pair_${tag}.err")
  rc=$?
  t1=$(date +%s.%N)
  cp "$dir/chiprun_out/chip_smoke.json" "chiprun_out/smoke_pair_${tag}_smoke.json" 2>/dev/null
  line="$tag rc=$rc seconds=$(python3 -c "print($t1-$t0)") rmvpe=$(grep -o '[0-9.]* s a segment' chiprun_out/smoke_pair_${tag}.log | head -1)"
  echo "$line"; summary="$summary
$line"
  tail -c 300 "chiprun_out/smoke_pair_${tag}.log"; echo
done
echo "SUMMARY:$summary"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
