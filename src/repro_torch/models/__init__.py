"""Model code of the port: the dense family's layers, attention, MLP,
transformer assembly and the ``ModelProgram`` ABI."""
