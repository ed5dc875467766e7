"""Distribution utilities (port of ``repro.dist``): logical-axis sharding
rules and their DTensor placements, activation constraints
(:mod:`.sharding`), and pipeline stages over the ranks of a mesh axis
(:mod:`.pipeline`)."""
