"""Cameras (render/camera.py) and the batched ray-cast renderer
(render/raster.py, render/meshtools.py)."""
