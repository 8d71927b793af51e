"""Camera projection (render/camera.py). Rendering itself is not ported yet."""
