"""Mesh-axis conventions for sharded serving (the serving part of the
reference's ``repro.dist``) and the int8 gradient compression
(``compress``); ZeRO, the optimizer specs and the activation ``hint`` come
with the training meshes."""
