"""FL loops, aggregation engine and client plane of the port."""
