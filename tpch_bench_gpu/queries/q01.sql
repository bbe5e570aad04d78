SELECT l_returnflag, l_linestatus, SUM(l_quantity) as sum_qty,
 SUM(l_extendedprice) as sum_base_price,
 SUM(l_extendedprice*(1-l_discount)) as sum_disc_price,
 SUM(l_extendedprice*(1-l_discount)*(1+l_tax)) as sum_charge,
 AVG(l_quantity) as avg_qty, AVG(l_extendedprice) as avg_price,
 AVG(l_discount) as avg_disc, COUNT(*) as count_order
 FROM lineitem WHERE l_shipdate <= '1998-12-01'
 GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus
