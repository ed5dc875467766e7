"""Distribution utilities (port of ``repro.dist``): logical-axis sharding
rules (:mod:`.sharding`) and pipeline stages (:mod:`.pipeline`), for one
device.  Runs on more than one card wait for ROADMAP queue 1, item 16."""
