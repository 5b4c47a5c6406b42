"""Training loops of the port: the bonus-abuse detector (``abuse_train``)."""
