"""Communication: process groups, the comms ledger, the compressed-
collective facade and its kernel backends."""
