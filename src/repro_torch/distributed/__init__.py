"""Distribution over a ``torch.distributed`` process mesh: sharding rules,
the sharding context, explicit collectives and head-sharded paged
serving (port of ``repro/distributed``)."""
