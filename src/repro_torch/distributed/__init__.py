"""Distribution over a ``torch.distributed`` process mesh: sharding rules,
the sharding context, explicit collectives (some inside autograd),
head-sharded paged serving and the sharded train step's compute plan
(port of ``repro/distributed``)."""
