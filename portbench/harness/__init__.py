"""The benchmark's own code: finding cells by name, loading tables into the
port, the trace reader, the roofline table and the comparison that decides
`correct`."""
