"""Mesh construction (the serving meshes; the training meshes come with
training)."""
