"""Model layer of the port: the Llama family's building blocks
(`llama`), the paged serving steps (`serving`) and the
continuous-batching engine (`engine`)."""
