"""obs of the PyTorch port: metrics, tracing and the flight recorder, OTLP
export, the SLO engine, the step-time model, and the drift observatory."""
