#!/usr/bin/env bash
# Live-viewer demo of the PyTorch port (flame_ros_torch): watch the mesh
# grow while the system runs, rviz-free.
#   1. flame_ros_torch.frontends.serve: the engine behind the TCP
#      streaming protocol, on DEVICE (the card by default; cpu works)
#   2. live_viewer: polls get_mesh, serves the auto-refreshing WebGL page
#   3. stream_synthetic_torch: feeds a posed synthetic sequence
# Open http://127.0.0.1:8047 while it runs to watch the mesh grow.
set -euo pipefail
cd "$(dirname "$0")/.."

FRAMES="${1:-200}"
RATE="${2:-10}"
PORT="${FLAME_PORT:-7447}"
HTTP_PORT="${FLAME_HTTP_PORT:-8047}"
DEVICE="${3:-cuda}"

python -m flame_ros_torch.frontends.serve \
  --fx 262.5 --fy 262.5 --cx 159.5 --cy 119.5 --width 320 --height 240 \
  --port "$PORT" --device "$DEVICE" &
SERVE_PID=$!
python -m flame_ros_torch.viz.live_viewer \
  --server-port "$PORT" --http-port "$HTTP_PORT" --period 0.5 &
VIEW_PID=$!
trap 'kill $SERVE_PID $VIEW_PID 2>/dev/null || true' EXIT
# Wait for the engine server to accept connections (its warmup builds
# the kernels first). Abort, and do not fall through, if it never comes
# up.
UP=0
for _ in $(seq 1 90); do
  if ! kill -0 "$SERVE_PID" 2>/dev/null; then
    echo "flame-serve exited during startup" >&2
    exit 1
  fi
  if python - "$PORT" <<'EOF'
import socket, sys
try:
    socket.create_connection(("127.0.0.1", int(sys.argv[1])), 1).close()
except OSError:
    raise SystemExit(1)
EOF
  then UP=1; break; fi
  sleep 2
done
if [ "$UP" != 1 ]; then
  echo "flame-serve never started listening on port $PORT" >&2
  exit 1
fi
echo "live mesh at http://127.0.0.1:$HTTP_PORT"
python scripts/stream_synthetic_torch.py --port "$PORT" \
  --frames "$FRAMES" --rate "$RATE" --device "$DEVICE"
echo "stream done; viewer stays up 10 s for a last look"
sleep 10
