"""Model layer of the port: the Llama and Gemma-2 families' building
blocks (`llama`, `gemma`), the serving steps (`serving`) and the
continuous-batching engine (`engine`)."""
