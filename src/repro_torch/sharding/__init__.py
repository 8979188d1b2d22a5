"""Logical-axis sharding rules and their DTensor placements (counterpart
of ``repro/sharding``)."""
