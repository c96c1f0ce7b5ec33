"""Model families of the port (dense transformer) behind one registry."""
