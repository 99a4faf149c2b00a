"""Traffic drivers, one module per `loop` kind of a traffic file."""
