"""The model zoo (port of `repro.models`): the six block families of
`model`, their decode path (`decode`, `kvquant`), the MoE, Mamba and xLSTM
blocks (`moe`, `ssm`, `xlstm`) and the shared layers (`layers`)."""
