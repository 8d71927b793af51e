"""Multi-device env-axis sharding (parallel/mesh.py)."""
