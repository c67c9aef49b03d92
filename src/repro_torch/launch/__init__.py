"""Mesh construction (the serving meshes; the training meshes are not
ported yet) and the single-device training launcher (``train``)."""
