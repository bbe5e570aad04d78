SELECT 100.00 *
 SUM(case when p_type like 'PROMO%' then l_extendedprice*(1-l_discount)
   else 0 end) / SUM(l_extendedprice * (1 - l_discount)) as promo_revenue
 FROM lineitem, part WHERE l_partkey = p_partkey
 AND l_shipdate >= '1995-09-01' AND l_shipdate < '1995-10-01'
