#!/usr/bin/env bash
# End-to-end demo (the reference's Docker example equivalent,
# scripts/flame_docker_example.sh): run the full engine over a synthetic
# posed sequence, evaluate against ground truth, and export an
# interactive mesh viewer, with the PyTorch port (flame_ros_torch) on
# DEVICE (the card by default; pass cpu as the third argument). No
# dataset download.
set -euo pipefail
cd "$(dirname "$0")/.."
OUT="${1:-run_out/flame_demo_torch}"
FRAMES="${2:-60}"
DEVICE="${3:-cuda}"

python -m flame_ros_torch.frontends.offline_runner \
  --dataset synthetic --frames "$FRAMES" --resolution qvga \
  --device "$DEVICE" --out "$OUT" --save-products --verbose

python - "$OUT" <<'EOF'
import sys, numpy as np
out = sys.argv[1]
mesh = np.load(f"{out}/final_mesh.npz")
from flame_ros_torch.viz.html_viewer import export_html_viewer
from flame_ros_torch.viz.export import write_ply_mesh
export_html_viewer(f"{out}/mesh_viewer.html", mesh["vertices_px"],
                   mesh["idepths"], mesh["normals"], mesh["triangles"],
                   mesh["tri_validity"], mesh["K"])
write_ply_mesh(f"{out}/mesh.ply", mesh["vertices_px"], mesh["idepths"],
               mesh["normals"], mesh["triangles"], mesh["tri_validity"],
               mesh["K"])
print(f"demo artifacts in {out}: stats.txt, telemetry.jsonl, "
      f"mesh_viewer.html, mesh.ply")
EOF
