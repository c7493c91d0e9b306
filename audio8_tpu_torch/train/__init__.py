"""Training of the port: optimizer and LR schedules (``optim``), the CTC
step factory (``steps``)."""
