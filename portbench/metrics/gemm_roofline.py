"""gemm_roofline: % of the chain's GEMMs' least time (each GEMM
max(2mnk / TF32 peak, (mk + kn + mn)·4 B / HBM bandwidth)) over the device
time of the kernels launched inside each timed call's span, whatever
computes them. Only calls whose kernels the trace holds are counted."""


def read(run):
    if run.trace is None or not run.calls.bounds:
        return None
    device = run.trace.call_device_s()
    matched = [i for i in run.calls.bounds if device.get(i, 0.0) > 0.0]
    if not matched:
        return None
    return 100.0 * sum(run.calls.bounds[i] for i in matched) / sum(device[i] for i in matched)
