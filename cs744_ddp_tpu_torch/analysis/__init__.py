"""Static analysis of the port's programs: the analytic cost model
(``costmodel``), which counts what one call of a program must do (flops,
HBM bytes, wire bytes) from the operators it dispatches on meta tensors."""
