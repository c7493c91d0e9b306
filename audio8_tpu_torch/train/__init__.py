"""Training of the port: optimizer and LR schedules (``optim``), the step
factories (``steps``), checkpoints with their resume files
(``checkpoint``) and the SIGTERM guard (``preempt``)."""
