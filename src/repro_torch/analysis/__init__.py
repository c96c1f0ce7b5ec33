"""Static analysis of the port's hot paths: the op-graph IR and its rules
(`lint`), trace-level checks and the allocator's window (`trace`), and
the H100 roofline terms (`roofline`)."""
