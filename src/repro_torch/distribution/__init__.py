"""Distribution: the sharding rules and the mesh's data movement."""
