"""Near-sensor serving gateway, frame path (torch port).

  sensors.py   — the seeded sensor fleet (a copy of the reference's)
  gateway.py   — the micro-batching front door: fixed bucket shapes,
                 deadline flush, admission control
  frontend.py  — the at-sensor stage (SC vs binary first layer), the host
                 stage and the link-payload accounting
  telemetry.py — the per-request energy / link-byte ledger (a copy)
"""
