"""Data crossing a link (port of ``repro.distributed``): the feature
wire format (``compression``).  Rig sharding over several cards and the
int8 gradient ring are ROADMAP A12."""
