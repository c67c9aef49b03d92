"""Mesh-axis conventions for sharded serving (the serving part of the
reference's ``repro.dist``; ZeRO, the optimizer specs and the activation
``hint`` come with training)."""
