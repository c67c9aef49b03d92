"""The mesh-axis conventions, specs and placement of sharded serving and
training (``sharding``), the moves between a mesh's devices
(``collectives``), GPipe over a ``"stage"`` axis (``pipeline``) and the
int8 gradient compression (``compress``)."""
