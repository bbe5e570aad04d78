SELECT ps_partkey, SUM(ps_supplycost * ps_availqty) as value
 FROM partsupp, supplier, nation WHERE ps_suppkey = s_suppkey
 AND s_nationkey = n_nationkey AND n_name = 'GERMANY'
 GROUP BY ps_partkey having SUM(ps_supplycost * ps_availqty) > (
   SELECT SUM(ps_supplycost * ps_availqty) * 0.0001 FROM partsupp, supplier,
   nation WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
   AND n_name = 'GERMANY') ORDER BY value DESC
