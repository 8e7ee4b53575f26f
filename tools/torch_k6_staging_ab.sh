#!/bin/sh
# Time the prefix-sum kernel K6 (csrc/scan.cu) with its slab staged in
# shared memory against the same kernel reading its input twice from
# global memory, on the 1080p frame's main-path calls, on one card.
#
#     sh tools/torch_k6_staging_ab.sh
#
# Copies the package into build/k6_read_twice/ with scan_plan's first plan
# (staged) skipped, so that every launch takes the read-twice path, then
# runs tools/torch_k6_k7_times.py --kernel sat_rows on this checkout and
# the copy in turns (staged, read twice, read twice, staged).  Needs a
# CUDA device and nvcc.
set -eu
root=$(cd "$(dirname "$0")/.." && pwd)
alt=$root/build/k6_read_twice
rm -rf "$alt"
mkdir -p "$alt"
cp -r "$root/underwater_image_enhancement_tpu_torch" "$root/chip_smoke.py" "$alt/"
scan=$alt/underwater_image_enhancement_tpu_torch/csrc/scan.cu
sed -i 's/for (int staged = 1; staged >= 0; --staged)/for (int staged = 0; staged >= 0; --staged)/' "$scan"
grep -q 'for (int staged = 0; staged >= 0' "$scan"
for r in "$root" "$alt" "$alt" "$root"; do
  python3 "$root/tools/torch_k6_k7_times.py" --root "$r" --kernel sat_rows
done
