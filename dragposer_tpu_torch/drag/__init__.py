"""The drag runtime: engine, batch-in-lanes Adam block (and kernel K1),
pipelined batched loop."""
