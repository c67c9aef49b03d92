"""Mesh construction (the production, training and serving meshes) and the
training launcher (``train``), on one device or a mesh."""
