"""Program drivers, one module per kind of traffic (see harness.py)."""
