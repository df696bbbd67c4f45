"""Scale-out over ``torch.distributed``: the port's copy of
``repro.parallel`` (collective strategies, pipeline planning, sharding
rules, the sharded sweep backend)."""
