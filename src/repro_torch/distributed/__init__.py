"""Distribution: the logical-axis sharding rules as DTensor placements
(``sharding.py``)."""
