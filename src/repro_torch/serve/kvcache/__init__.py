"""Paged KV cache: refcounted block pool (``pool``, a copy of the
reference's numpy module) + block-table slot adapter (``paged``)."""
