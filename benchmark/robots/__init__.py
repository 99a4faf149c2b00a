"""The port's robot models built from a configuration's tables through
the port's public constructors, one module per robot kind."""
