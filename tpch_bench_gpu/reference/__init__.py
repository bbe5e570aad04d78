"""The plain reference: one module a TPC-H query (qNN.py), each with
`answer(data, acc)` and the `ORDER_BY` of its text, over common.Data."""
