"""Job entry points of the port (TPUJob/JAXJob workers)."""
