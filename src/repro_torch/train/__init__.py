"""Training of the port: the train step and the fault-tolerant loop."""
