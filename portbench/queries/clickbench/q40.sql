SELECT "URLHash", "EventDate", COUNT(*) AS c FROM hits
WHERE "IsRefresh" = 0 AND "TraficSourceID" IN (-1, 6)
  AND "RefererHash" = 123456
GROUP BY "URLHash", "EventDate" ORDER BY c DESC LIMIT 10
