"""Host data pipeline of the port: audio decoding and training batches."""
